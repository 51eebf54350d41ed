"""XLA backend compilations JAX reported inside the window; 0 when the
warm-up covered every shape."""


def read(record):
    return record["compiles_in_window"]
