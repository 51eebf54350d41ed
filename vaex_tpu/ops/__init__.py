"""Device compute kernels: the replacement of the reference's C++
layer (vaex-core/src: superagg, vaexfast, hash_primitives, superstrings).

Submodules:
  nullable  — the (data, validity) pytree every traced op computes on
  binners   — bin-index computation with the reference's +3-edge layout
  gridagg   — binned grid aggregation (scatter / sort strategies)
  setops    — sorted-set kernels replacing the sharded hashmaps
"""

from .nullable import NA, wrap, unwrap  # noqa: F401
