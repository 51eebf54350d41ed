"""NA — nullable device array, the unit of data inside a traced pass.

Re-design of the reference's ``vaex/arrow/numpy_dispatch.py`` (NumpyDispatch
wrapper that computes on numpy while carrying arrow null bitmaps).  Here the
wrapper is a registered JAX pytree holding ``data`` (a jnp array) and an
optional boolean ``mask`` (True == missing, numpy.ma convention).  All
expression operators and registered functions compute on NA values *at trace
time*, so null propagation is baked into the single compiled XLA program for a
pass — there is no per-chunk dispatch overhead at run time.

NaN and null are distinct, as in the reference (SURVEY §2.4): NaN lives in
``data``, null lives in ``mask``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_pytree_node_class
class NA:
    """data + optional validity. Immutable."""

    __slots__ = ("data", "mask")
    __array_priority__ = 100  # beat numpy operator dispatch

    def __init__(self, data, mask=None):
        self.data = data
        self.mask = mask

    def tree_flatten(self):
        if self.mask is None:
            return (self.data,), ("nomask",)
        return (self.data, self.mask), ("mask",)

    @classmethod
    def tree_unflatten(cls, aux, children):
        if aux[0] == "nomask":
            return cls(children[0], None)
        return cls(children[0], children[1])

    # -- basic properties ----------------------------------------------------
    @property
    def dtype(self):
        return self.data.dtype

    @property
    def shape(self):
        return self.data.shape

    @property
    def ndim(self):
        return self.data.ndim

    def __len__(self):
        return self.data.shape[0]

    def astype(self, dtype):
        return NA(self.data.astype(dtype), self.mask)

    def __repr__(self):
        return f"NA({self.data!r}, mask={self.mask!r})"

    # -- mask helpers --------------------------------------------------------
    def maskarray(self):
        """Always-materialized mask (False where no mask)."""
        if self.mask is None:
            return jnp.zeros(self.data.shape, dtype=bool)
        return self.mask

    def valid(self):
        """True where the value is present."""
        if self.mask is None:
            return jnp.ones(self.data.shape, dtype=bool)
        return ~self.mask

    def fill(self, value):
        """data with masked entries replaced by value; drops the mask."""
        if self.mask is None:
            return self.data
        return jnp.where(self.mask, jnp.asarray(value, dtype=self.data.dtype), self.data)


def _mask_or(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return a | b


def wrap(x) -> NA:
    if isinstance(x, NA):
        return x
    if isinstance(x, np.ma.MaskedArray):
        mask = np.ma.getmaskarray(x)
        return NA(jnp.asarray(x.data), jnp.asarray(mask) if mask.any() else None)
    return NA(jnp.asarray(x) if not isinstance(x, jnp.ndarray) else x, None)


def unwrap(x):
    """NA -> host numpy (masked array if it carries nulls)."""
    if not isinstance(x, NA):
        return np.asarray(x)
    data = np.asarray(x.data)
    if x.mask is None:
        return data
    mask = np.asarray(x.mask)
    if not mask.any():
        return data
    return np.ma.MaskedArray(data, mask)


def lift(op, *args, bool_out=False):
    """Apply op to the .data of NA/plain args, OR-combining masks."""
    datas = []
    mask = None
    for a in args:
        if isinstance(a, NA):
            datas.append(a.data)
            mask = _mask_or(mask, a.mask)
        else:
            datas.append(a)
    return NA(op(*datas), mask)


def _binop(op, reflected=False):
    def method(self, other):
        if isinstance(other, (list, tuple)):
            other = jnp.asarray(np.asarray(other))
        if reflected:
            return lift(lambda a, b: op(b, a), self, other)
        return lift(op, self, other)
    return method


def _install_operators():
    import operator
    ops = {
        "add": operator.add, "sub": operator.sub, "mul": operator.mul,
        "truediv": operator.truediv, "floordiv": operator.floordiv,
        "mod": operator.mod, "pow": operator.pow,
        "and": operator.and_, "or": operator.or_, "xor": operator.xor,
        "lshift": operator.lshift, "rshift": operator.rshift,
        "lt": operator.lt, "le": operator.le, "gt": operator.gt,
        "ge": operator.ge, "eq": operator.eq, "ne": operator.ne,
        "matmul": operator.matmul,
    }
    for name, op in ops.items():
        setattr(NA, f"__{name}__", _binop(op))
        if name not in ("lt", "le", "gt", "ge", "eq", "ne"):
            setattr(NA, f"__r{name}__", _binop(op, reflected=True))
    NA.__neg__ = lambda self: NA(-self.data, self.mask)
    NA.__pos__ = lambda self: NA(+self.data, self.mask)
    NA.__abs__ = lambda self: NA(jnp.abs(self.data), self.mask)
    NA.__invert__ = lambda self: NA(~self.data, self.mask)


_install_operators()
