"""The expression-namespace functions.

Re-design of the reference's ``vaex/functions.py`` (2738 LoC).  Three families:

* numpy-ufunc-named math — registered with a *device* impl (traced jnp over
  :class:`~vaex_tpu.ops.nullable.NA`, mask propagation baked into the trace)
  and a *host* impl (numpy over masked arrays) so the same expression string
  runs in a compiled pass or on a host chunk.
* NaN/null helpers — ``ismissing/isnan/isna/fillna/...`` with the reference's
  semantics (NaN and null are distinct; reference functions.py:146-266).
* ``dt_*`` / ``td_*`` / ``str_*`` — *host-only* (calendar math via pandas,
  string kernels via pyarrow.compute, reference functions.py:298-2391); the
  executor evaluates these on CPU per chunk and ships results (or dictionary
  codes) to the device.

Set-based internals (``_ordinal_values``, ``isin_set``) live here too; they
look up keys in a :class:`vaex_tpu.ops.setops.SortedSet` by binary search —
the device replacement for the reference's hashmap probes
(functions.py:2442-2567).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

try:
    import pyarrow as pa
    import pyarrow.compute as pc
except ImportError:  # pragma: no cover
    pa = pc = None

from . import array_types
from .ops.nullable import NA, lift
from .registry import register_function

# ---------------------------------------------------------------------------
# helpers


def _host_split(x):
    """host array -> (data ndarray, mask ndarray-or-None)"""
    return array_types.data_and_mask(x)


def _host_rejoin(data, mask):
    if mask is None or not np.any(mask):
        return data
    return np.ma.MaskedArray(data, mask)


def _host_elementwise(op):
    def impl(*args):
        datas, mask = [], None
        for a in args:
            if isinstance(a, (np.ndarray, np.ma.MaskedArray)) or (pa is not None and isinstance(a, (pa.Array, pa.ChunkedArray))):
                d, m = _host_split(a)
                datas.append(d)
                if m is not None:
                    mask = m if mask is None else (mask | m)
            else:
                datas.append(a)
        return _host_rejoin(op(*datas), mask)
    return impl


def _device_elementwise(op):
    def impl(*args):
        args = [a if isinstance(a, NA) or np.isscalar(a) or isinstance(a, (int, float, bool)) else NA(jnp.asarray(a))
                for a in args]
        return lift(op, *args)
    return impl


# ---------------------------------------------------------------------------
# numpy-named ufuncs (reference functions.py:50-105)

_UNARY_UFUNCS = [
    "abs", "arccos", "arccosh", "arcsin", "arcsinh", "arctan", "arctanh",
    "cos", "cosh", "deg2rad", "exp", "expm1", "log", "log10", "log1p",
    "rad2deg", "sin", "sinc", "sinh", "sqrt", "tan", "tanh", "floor", "ceil",
    "sign", "degrees", "radians", "exp2", "log2", "rint", "cbrt",
]
_BINARY_UFUNCS = ["arctan2", "maximum", "minimum", "power", "fmod", "hypot",
                  "copysign", "logaddexp"]

for _name in _UNARY_UFUNCS + _BINARY_UFUNCS:
    register_function(name=_name,
                      device=_device_elementwise(getattr(jnp, _name)),
                      host=_host_elementwise(getattr(np, _name)))(None)

register_function(name="round",
                  device=_device_elementwise(jnp.round),
                  host=_host_elementwise(np.round))(None)


def _clip_device(x, a_min=None, a_max=None):
    return lift(lambda d: jnp.clip(d, a_min, a_max), x if isinstance(x, NA) else NA(jnp.asarray(x)))


register_function(name="clip", device=_clip_device,
                  host=_host_elementwise(lambda d, a_min=None, a_max=None: np.clip(d, a_min, a_max)))(None)


def _searchsorted_device(ar, values, side="left"):
    ar = ar if isinstance(ar, NA) else NA(jnp.asarray(np.asarray(ar)))
    values = values if isinstance(values, NA) else NA(jnp.asarray(np.asarray(values)))
    return NA(jnp.searchsorted(values.data, ar.data, side=side), ar.mask)


def _searchsorted_host(ar, values, side="left"):
    d, m = _host_split(ar)
    return _host_rejoin(np.searchsorted(np.asarray(values), d, side=side), m)


register_function(name="searchsorted", device=_searchsorted_device, host=_searchsorted_host)(None)


def _digitize_device(x, bins, right=False):
    x = x if isinstance(x, NA) else NA(jnp.asarray(np.asarray(x)))
    return NA(jnp.digitize(x.data, jnp.asarray(np.asarray(bins)), right=right), x.mask)


register_function(name="digitize", device=_digitize_device,
                  host=_host_elementwise(lambda d, bins, right=False: np.digitize(d, np.asarray(bins), right=right)))(None)

# ---------------------------------------------------------------------------
# NaN / null helpers (reference functions.py:146-266)


def _ismissing_device(x):
    if not isinstance(x, NA):
        return NA(jnp.zeros(jnp.asarray(x).shape, bool))
    return NA(x.maskarray())


def _ismissing_host(x):
    d, m = _host_split(x)
    return m.copy() if m is not None else np.zeros(len(d), dtype=bool)


register_function(name="ismissing", device=_ismissing_device, host=_ismissing_host)(None)


def _isnan_device(x):
    x = x if isinstance(x, NA) else NA(jnp.asarray(x))
    if jnp.issubdtype(x.data.dtype, jnp.floating):
        return NA(jnp.isnan(x.data) & x.valid())
    return NA(jnp.zeros(x.shape, bool))


def _isnan_host(x):
    d, m = _host_split(x)
    if d.dtype.kind == "f":
        out = np.isnan(d)
        if m is not None:
            out &= ~m
        return out
    return np.zeros(len(d), dtype=bool)


register_function(name="isnan", device=_isnan_device, host=_isnan_host)(None)


def _isna_device(x):
    return NA(_isnan_device(x).data | _ismissing_device(x).data)


def _isna_host(x):
    return _isnan_host(x) | _ismissing_host(x)


register_function(name="isna", device=_isna_device, host=_isna_host)(None)
register_function(name="notna", device=lambda x: NA(~_isna_device(x).data),
                  host=lambda x: ~_isna_host(x))(None)
register_function(name="isfinite", device=_device_elementwise(jnp.isfinite),
                  host=_host_elementwise(np.isfinite))(None)
register_function(name="isinf", device=_device_elementwise(jnp.isinf),
                  host=_host_elementwise(np.isinf))(None)


def _fillmissing_device(x, value):
    x = x if isinstance(x, NA) else NA(jnp.asarray(x))
    if x.mask is None:
        return x
    return NA(jnp.where(x.mask, jnp.asarray(value).astype(x.data.dtype), x.data))


def _fillmissing_host(x, value):
    d, m = _host_split(x)
    if m is None:
        return d
    out = d.copy()
    out[m] = value
    return out


register_function(name="fillmissing", device=_fillmissing_device, host=_fillmissing_host)(None)


def _fillnan_device(x, value):
    x = x if isinstance(x, NA) else NA(jnp.asarray(x))
    if jnp.issubdtype(x.data.dtype, jnp.floating):
        return NA(jnp.where(jnp.isnan(x.data), jnp.asarray(value, x.data.dtype), x.data), x.mask)
    return x


def _fillnan_host(x, value):
    d, m = _host_split(x)
    if d.dtype.kind == "f":
        d = np.where(np.isnan(d), value, d)
    return _host_rejoin(d, m)


register_function(name="fillnan", device=_fillnan_device, host=_fillnan_host)(None)


def _fillna_device(x, value):
    return _fillnan_device(_fillmissing_device(x, value), value)


def _fillna_host(x, value):
    return _fillnan_host(_fillmissing_host(x, value), value)


register_function(name="fillna", device=_fillna_device, host=_fillna_host)(None)

# ---------------------------------------------------------------------------
# structural ops


def _where_device(cond, a, b):
    datas = []
    mask = None
    for v in (cond, a, b):
        if isinstance(v, NA):
            datas.append(v.data)
            mask = v.mask if mask is None else (mask | v.mask if v.mask is not None else mask)
        else:
            datas.append(v)
    return NA(jnp.where(*datas), mask)


register_function(name="where", device=_where_device,
                  host=_host_elementwise(np.where))(None)


def _astype_device(x, dtype):
    x = x if isinstance(x, NA) else NA(jnp.asarray(x))
    return NA(x.data.astype(np.dtype(dtype)), x.mask)


def _astype_host(x, dtype):
    if dtype in ("str", "string"):
        d, m = _host_split(x)
        return _host_rejoin(np.asarray([str(v) for v in d], dtype=object), m)
    d, m = _host_split(x)
    return _host_rejoin(d.astype(np.dtype(dtype)), m)


register_function(name="astype", device=_astype_device, host=_astype_host)(None)


# ---------------------------------------------------------------------------
# set-based internals (reference functions.py:2442-2567): the variable named in
# the expression resolves (via the scope) to a SortedSet; lookups are binary
# searches on the sorted key array — the device hashmap probe.


def _ordinal_values_device(x, oset):
    from .ops import setops
    x = x if isinstance(x, NA) else NA(jnp.asarray(x))
    return NA(setops.device_map_ordinal(oset, x))


def _ordinal_values_host(x, oset):
    from .ops import setops
    return setops.host_map_ordinal(oset, x)


register_function(name="_ordinal_values", device=_ordinal_values_device,
                  host=_ordinal_values_host)(None)


def _isin_set_device(x, oset):
    from .ops import setops
    x = x if isinstance(x, NA) else NA(jnp.asarray(x))
    return NA(setops.device_isin(oset, x))


def _isin_set_host(x, oset):
    from .ops import setops
    return setops.host_isin(oset, x)


register_function(name="isin_set", device=_isin_set_device, host=_isin_set_host)(None)


def _choose_device(codes, choices):
    """codes index into a (device) choices array; masked codes stay masked."""
    codes = codes if isinstance(codes, NA) else NA(jnp.asarray(codes))
    table = choices.data if isinstance(choices, NA) else jnp.asarray(np.asarray(choices))
    safe = jnp.clip(codes.data, 0, table.shape[0] - 1)
    mask = codes.mask
    oob = (codes.data < 0) | (codes.data >= table.shape[0])
    mask = oob if mask is None else (mask | oob)
    return NA(table[safe], mask)


def _choose_host(codes, choices):
    d, m = _host_split(codes)
    table = np.asarray(choices)
    oob = (d < 0) | (d >= len(table))
    safe = np.clip(d, 0, max(len(table) - 1, 0))
    out = table[safe]
    mask = oob if m is None else (m | oob)
    return _host_rejoin(out, mask)


register_function(name="_choose", device=_choose_device, host=_choose_host)(None)

# ---------------------------------------------------------------------------
# dt_* / td_* — host-only calendar ops via pandas (reference functions.py:298-957)


def _via_pandas(attr, is_method=False, is_td=False):
    def impl(x, *args, **kwargs):
        import pandas as pd
        d, m = _host_split(x)
        series = pd.Series(d)
        acc = series.dt
        val = getattr(acc, attr)
        if is_method:
            val = val(*args, **kwargs)
        out = val.to_numpy()
        return _host_rejoin(out, m)
    return impl


_DT_PROPS = ["year", "month", "day", "hour", "minute", "second", "microsecond",
             "nanosecond", "dayofweek", "dayofyear", "daysinmonth", "quarter",
             "is_leap_year", "date"]
for _p in _DT_PROPS:
    register_function(scope="dt", name=_p, as_property=True, host=_via_pandas(_p))(None)

def _weekofyear_host(x):
    import pandas as pd
    d, m = _host_split(x)
    out = pd.Series(d).dt.isocalendar().week.to_numpy().astype(np.int64)
    return _host_rejoin(out, m)


register_function(scope="dt", name="weekofyear", as_property=True, host=_weekofyear_host)(None)

for _meth in ["strftime", "floor", "day_name", "month_name"]:
    register_function(scope="dt", name=_meth, host=_via_pandas(_meth, is_method=True))(None)


def _td_via_pandas(attr, is_method=False):
    def impl(x, *args, **kwargs):
        import pandas as pd
        d, m = _host_split(x)
        acc = pd.Series(d).dt
        val = getattr(acc, attr)
        if is_method:
            val = val(*args, **kwargs)
        return _host_rejoin(np.asarray(val), m)
    return impl


for _p in ["days", "seconds", "microseconds", "nanoseconds"]:
    register_function(scope="td", name=_p, as_property=True, host=_td_via_pandas(_p))(None)
register_function(scope="td", name="total_seconds", host=_td_via_pandas("total_seconds", is_method=True))(None)

# ---------------------------------------------------------------------------
# str_* — host-only string kernels via pyarrow.compute
# (reference functions.py:958-2391, _arrow_string_kernel_dispatch)


def _to_pa(x):
    return array_types.to_arrow(x)


def _dict_aware(fn):
    """Run a per-value arrow kernel at O(dictionary) for dictionary-encoded
    inputs (to_device string columns): transform the U dictionary values
    once, recompose by indices — string results stay dictionary-encoded
    (lazy), scalar results gather (reference: O(N) per-row kernels always,
    strings.cpp:727-795; dictionary-valued ops O(U))."""
    def impl(x, *args, **kwargs):
        a = _to_pa(x)
        if isinstance(a, pa.ChunkedArray):
            a = a.combine_chunks()
        if isinstance(a, pa.Array) and pa.types.is_dictionary(a.type):
            vals = fn(a.dictionary, *args, **kwargs)
            if pa.types.is_string(vals.type) or pa.types.is_large_string(vals.type):
                return pa.DictionaryArray.from_arrays(a.indices, vals)
            return vals.take(a.indices)
        return fn(a, *args, **kwargs)
    return impl


def _str_simple(pc_name):
    def kernel(a, *args, **kwargs):
        return getattr(pc, pc_name)(a, *args, **kwargs)
    return _dict_aware(kernel)


_STR_SIMPLE = {
    "capitalize": "utf8_capitalize",
    "lower": "utf8_lower",
    "upper": "utf8_upper",
    "title": "utf8_title",
    "swapcase": "utf8_swapcase",
    "isalnum": "utf8_is_alnum",
    "isalpha": "utf8_is_alpha",
    "isdigit": "utf8_is_digit",
    "isspace": "utf8_is_space",
    "islower": "utf8_is_lower",
    "isupper": "utf8_is_upper",
    "istitle": "utf8_is_title",
    "len": "utf8_length",
    "byte_length": "binary_length",
    "reverse": "utf8_reverse",
    "trim_whitespace": "utf8_trim_whitespace",
}
for _name, _pc_name in _STR_SIMPLE.items():
    register_function(scope="str", name=_name, host=_str_simple(_pc_name))(None)


@_dict_aware
def _str_strip(a, to_strip=None):
    return pc.utf8_trim_whitespace(a) if to_strip is None else pc.utf8_trim(a, characters=to_strip)


@_dict_aware
def _str_lstrip(a, to_strip=None):
    return pc.utf8_ltrim_whitespace(a) if to_strip is None else pc.utf8_ltrim(a, characters=to_strip)


@_dict_aware
def _str_rstrip(a, to_strip=None):
    return pc.utf8_rtrim_whitespace(a) if to_strip is None else pc.utf8_rtrim(a, characters=to_strip)


register_function(scope="str", name="strip", host=_str_strip)(None)
register_function(scope="str", name="lstrip", host=_str_lstrip)(None)
register_function(scope="str", name="rstrip", host=_str_rstrip)(None)


@_dict_aware
def _str_contains(a, pattern, regex=True):
    if regex:
        return pc.match_substring_regex(a, pattern)
    return pc.match_substring(a, pattern)


register_function(scope="str", name="contains", host=_str_contains)(None)
register_function(scope="str", name="startswith",
                  host=_dict_aware(lambda a, pat: pc.starts_with(a, pattern=pat)))(None)
register_function(scope="str", name="endswith",
                  host=_dict_aware(lambda a, pat: pc.ends_with(a, pattern=pat)))(None)
register_function(scope="str", name="match",
                  host=_dict_aware(lambda a, pat: pc.match_like(a, pat) if "%" in str(pat)
                                   else pc.match_substring_regex(a, "^(" + str(pat) + ")$")))(None)
register_function(scope="str", name="equals",
                  host=lambda x, y: pc.equal(_decoded(x), _decoded(y) if not isinstance(y, str) else y))(None)
register_function(scope="str", name="count",
                  host=_dict_aware(lambda a, pat, regex=True:
                                   (pc.count_substring_regex if regex else pc.count_substring)(a, pat)))(None)
register_function(scope="str", name="find",
                  host=_dict_aware(lambda a, sub: pc.find_substring(a, sub)))(None)


@_dict_aware
def _str_replace(a, pat, repl, n=-1, regex=False):
    kwargs = {} if n == -1 else {"max_replacements": n}
    if regex:
        return pc.replace_substring_regex(a, pat, repl, **kwargs)
    return pc.replace_substring(a, pat, repl, **kwargs)


register_function(scope="str", name="replace", host=_str_replace)(None)


@_dict_aware
def _str_slice(a, start=0, stop=None):
    return pc.utf8_slice_codeunits(a, start=start, stop=stop if stop is not None else 2**31 - 1)


register_function(scope="str", name="slice", host=_str_slice)(None)


@_dict_aware
def _str_pad(a, width, side="left", fillchar=" "):
    if side == "left":
        return pc.utf8_lpad(a, width=width, padding=fillchar)
    if side == "right":
        return pc.utf8_rpad(a, width=width, padding=fillchar)
    return pc.utf8_center(a, width=width, padding=fillchar)


register_function(scope="str", name="pad", host=_str_pad)(None)
register_function(scope="str", name="ljust",
                  host=_dict_aware(lambda a, width, fillchar=" ": pc.utf8_rpad(a, width=width, padding=fillchar)))(None)
register_function(scope="str", name="rjust",
                  host=_dict_aware(lambda a, width, fillchar=" ": pc.utf8_lpad(a, width=width, padding=fillchar)))(None)
register_function(scope="str", name="zfill",
                  host=_dict_aware(lambda a, width: pc.utf8_lpad(a, width=width, padding="0")))(None)
register_function(scope="str", name="repeat",
                  host=_dict_aware(lambda a, repeats: pc.binary_repeat(a, repeats)))(None)


def _decoded(x):
    a = _to_pa(x)
    if isinstance(a, pa.ChunkedArray):
        a = a.combine_chunks()
    if isinstance(a, pa.Array) and pa.types.is_dictionary(a.type):
        return a.dictionary_decode()
    return a


def _str_cat(x, other):
    return pc.binary_join_element_wise(
        _decoded(x), _decoded(other) if not isinstance(other, str) else other, "")


register_function(scope="str", name="cat", host=_str_cat)(None)


@_dict_aware
def _str_split(a, pattern=" ", max_splits=None, regex=False):
    """split -> arrow list array (reference strings.cpp split / StringListList)."""
    kwargs = {} if max_splits is None else {"max_splits": max_splits}
    if regex:
        return pc.split_pattern_regex(a, pattern, **kwargs)
    return pc.split_pattern(a, pattern, **kwargs)


register_function(scope="str", name="split", host=_str_split)(None)


def _str_join(x, separator=" "):
    """join a list-of-strings column back into strings."""
    return pc.binary_join(_to_pa(x), separator)


register_function(scope="str", name="join", host=_str_join)(None)
register_function(scope="str", name="title", host=_str_simple("utf8_title"))(None)
register_function(scope="str", name="capitalize", host=_str_simple("utf8_capitalize"))(None)
register_function(scope="str", name="isnumeric", host=_str_simple("utf8_is_numeric"))(None)
register_function(scope="str", name="len_unicode", host=_str_simple("utf8_length"))(None)
register_function(scope="str", name="index_of",
                  host=lambda x, sub: pc.find_substring(_to_pa(x), sub))(None)
register_function(scope="str", name="extract_regex",
                  host=lambda x, pat: pc.extract_regex(_to_pa(x), pat))(None)
register_function(scope="str", name="count_substring",
                  host=lambda x, sub: pc.count_substring(_to_pa(x), sub))(None)


def _pnpoly_kernel(np_mod, x, y, xp_, yp_):
    """Crossing-number point-in-polygon (replaces vaexfast.cpp:1757 pnpoly)."""
    inside = np_mod.zeros(x.shape, bool)
    n = len(xp_)
    j = n - 1
    for i in range(n):
        x0, y0 = xp_[j], yp_[j]
        x1, y1 = xp_[i], yp_[i]
        denom = (y0 - y1)
        denom = denom if denom != 0 else 1e-300
        crosses = ((y1 > y) != (y0 > y)) & (x < (x0 - x1) * (y - y1) / denom + x1)
        inside = inside ^ crosses
        j = i
    return inside


def _pnpoly_device(x, y, xp_, yp_):
    import jax.numpy as jnp_mod
    x = x if isinstance(x, NA) else NA(jnp.asarray(x))
    y = y if isinstance(y, NA) else NA(jnp.asarray(y))
    xp_ = np.asarray(xp_, np.float64)
    yp_ = np.asarray(yp_, np.float64)
    inside = _pnpoly_kernel(jnp_mod, x.data, y.data, xp_, yp_)
    mask = x.mask if y.mask is None else (y.mask if x.mask is None else (x.mask | y.mask))
    if mask is not None:
        inside = inside & ~mask
    return NA(inside)


def _pnpoly_host(x, y, xp_, yp_):
    xd, xm = _host_split(x)
    yd, ym = _host_split(y)
    inside = _pnpoly_kernel(np, xd, yd, np.asarray(xp_, np.float64), np.asarray(yp_, np.float64))
    mask = xm if ym is None else (ym if xm is None else (xm | ym))
    if mask is not None:
        inside &= ~mask
    return inside


register_function(name="pnpoly", device=_pnpoly_device, host=_pnpoly_host)(None)


def _to_string_host(x):
    d, m = _host_split(x)
    out = np.asarray([str(v) for v in d], dtype=object)
    return _host_rejoin(out, m)


register_function(name="to_string", host=_to_string_host)(None)


def _format_host(x, fmt):
    d, m = _host_split(x)
    out = np.asarray([fmt.format(v) for v in d], dtype=object)
    return _host_rejoin(out, m)


register_function(name="format", host=_format_host)(None)
