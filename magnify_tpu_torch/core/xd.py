"""Labeled n-dimensional arrays: the framework's data model (layer L0).

The reference framework (FordyceLab/magnify) represents every pipeline stage as
an ``xarray.Dataset`` holding a ``tile``/``image``/``roi`` data variable plus
``fg``/``bg``/``x``/``y``/``valid``/``tag`` coordinates (see
magnify/preprocess.py:11-41 for the canonical layout).
xarray is not part of this framework's dependency set, so this module provides
a small, self-contained labeled-array model with the subset of semantics the
pipelines need:

* named dimensions + coordinate variables (dim coords and non-dim coords),
* ``sel``/``isel``/``transpose``/``squeeze``/``expand_dims``,
* ``stack``/``unstack`` with a recorded multi-index (``mark`` =
  ``mark_row`` x ``mark_col``, mirroring magnify/find.py:182),
* dim-aligned broadcasting arithmetic, ``where`` masking and skipna
  reductions (mirroring the masked fg/bg statistics in
  magnify/identify.py:76-81),
* a pluggable duck-array backend so variables can be lazily chunked
  (:mod:`magnify_tpu_torch.core.lazy`) instead of dask-backed.

Device interplay: data here lives on host (numpy or a lazy ChunkedArray).
Torch tensors enter and leave through the ops layer; components materialize
host blocks, copy them to the device, and write numpy results back into the
model.
"""

from __future__ import annotations

import copy
from collections.abc import Mapping, Sequence

import numpy as np

__all__ = ["DataArray", "Dataset", "Variable", "concat"]


def _is_lazy(data) -> bool:
    """True for duck arrays that need explicit materialization."""
    return hasattr(data, "compute") and not isinstance(data, np.ndarray)


def _materialize(data) -> np.ndarray:
    if _is_lazy(data):
        return np.asarray(data.compute())
    return np.asarray(data)


class Variable:
    """A named-dimension array: ``dims`` + ``data`` + ``attrs``.

    ``data`` may be a numpy array, a scalar, or any duck array exposing
    ``shape``/``dtype``/``__getitem__``/``compute`` (e.g. a lazy
    :class:`~magnify_tpu_torch.core.lazy.ChunkedArray`).
    """

    __slots__ = ("dims", "data", "attrs")

    def __init__(self, dims, data, attrs=None):
        if isinstance(dims, str):
            dims = (dims,)
        dims = tuple(dims)
        if not _is_lazy(data) and not isinstance(data, np.ndarray):
            data = np.asarray(data)
        if len(dims) != len(data.shape):
            raise ValueError(
                f"dims {dims} do not match data of shape {data.shape}"
            )
        self.dims = dims
        self.data = data
        self.attrs = dict(attrs) if attrs else {}

    # -- basic introspection -------------------------------------------------
    @property
    def shape(self):
        return tuple(self.data.shape)

    @property
    def ndim(self):
        return len(self.dims)

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def sizes(self):
        return dict(zip(self.dims, self.shape))

    def copy(self, data=None):
        return Variable(self.dims, self.data if data is None else data, self.attrs)

    def compute(self) -> "Variable":
        return Variable(self.dims, _materialize(self.data), self.attrs)

    @property
    def values(self) -> np.ndarray:
        return _materialize(self.data)

    # -- indexing -------------------------------------------------------------
    def isel(self, indexers: Mapping[str, object]) -> "Variable":
        key = []
        new_dims = []
        for d in self.dims:
            idx = indexers.get(d, slice(None))
            key.append(idx)
            if not np.isscalar(idx) and not isinstance(idx, (int, np.integer)):
                new_dims.append(d)
        data = self.data[tuple(key)]
        # Fancy (array) indexers on multiple dims are applied one dim at a
        # time by callers; here at most basic indexing is assumed except
        # 1-d array indexers on a single dim.
        return Variable(tuple(new_dims), data, self.attrs)

    def transpose(self, order: Sequence[str]) -> "Variable":
        order = [d for d in order if d in self.dims]
        missing = [d for d in self.dims if d not in order]
        order = list(order) + missing if set(order) != set(self.dims) else list(order)
        axes = tuple(self.dims.index(d) for d in order)
        if axes == tuple(range(self.ndim)):
            return self
        if _is_lazy(self.data) and hasattr(self.data, "transpose"):
            data = self.data.transpose(axes)
        else:
            data = np.transpose(_materialize(self.data), axes)
        return Variable(tuple(order), data, self.attrs)

    def expand_dims(self, dim: str, axis: int = 0) -> "Variable":
        if _is_lazy(self.data) and hasattr(self.data, "expand_dims"):
            data = self.data.expand_dims(axis)
        else:
            data = np.expand_dims(_materialize(self.data), axis)
        dims = list(self.dims)
        dims.insert(axis, dim)
        return Variable(tuple(dims), data, self.attrs)

    def reshape_dims(self, dims, shape) -> "Variable":
        data = _materialize(self.data).reshape(shape)
        return Variable(dims, data, self.attrs)

    def __repr__(self):
        return f"Variable(dims={self.dims}, shape={self.shape}, dtype={self.dtype})"


def _regular_to_slice(idx, length: int):
    """Rewrite a 1-D integer-array indexer with a constant positive stride
    (e.g. the identity selection ``sel(channel=<all channels in order>)``)
    as the equivalent slice. Outer indexing by such an array equals the
    slice exactly, but numpy's advanced indexing materializes a copy —
    ~100 MB/s on a middle axis — where the slice is a free view. Returns
    ``idx`` unchanged when no slice is equivalent: non-constant or
    non-positive strides, negative indices, and any index >= ``length``
    (a slice would silently clamp where advanced indexing raises
    IndexError — the array is kept so the error stays loud). The
    resulting selection may be a VIEW of the parent store; callers that
    mutate results go through ``_protect_rewritten_view``.
    """
    if not isinstance(idx, np.ndarray) or idx.ndim != 1 \
            or idx.dtype.kind not in "iu" or len(idx) == 0:
        return idx
    # Unsigned dtypes wrap under np.diff (a descending uint sequence
    # yields a huge positive "step"); do the arithmetic in int64.
    vals = idx.astype(np.int64, copy=False)
    if int(vals[0]) < 0 or int(vals[-1]) >= length:
        return idx
    if len(vals) == 1:
        start = int(vals[0])
        return slice(start, start + 1)
    steps = np.diff(vals)
    step = int(steps[0])
    if step <= 0 or (steps != step).any():
        return idx
    return slice(int(vals[0]), int(vals[-1]) + 1, step)


def _isel_var(var: Variable, indexers) -> Variable:
    """Apply a dict of indexers to a Variable.

    On lazy data ALL indexers go through ONE ``Variable.isel`` call: a
    single region read touching only the intersecting chunks, with per-dim
    (outer/xarray-style) semantics for array indexers applied by
    ``ChunkedArray.__getitem__``. (Applying indexers dim-by-dim materialized
    the full extent of every not-yet-indexed dim per step: reading one
    (channel, time) plane of a lazy 4-D stack loaded the whole channel, a
    40x IO/RSS blowup on the 10.7 GB out-of-core proof.)

    On in-memory data, basic indexers (ints/slices) are applied together
    (numpy basic indexing, a view), then fancy array indexers one dim at a
    time so they take per-dim outer semantics instead of numpy broadcasting.
    """
    applicable = {d: i for d, i in indexers.items() if d in var.dims}
    if not applicable:
        return var
    rewritten = False
    norm = {}
    for d, i in applicable.items():
        if isinstance(i, (list, np.ndarray)):
            conv = _regular_to_slice(np.asarray(i),
                                     var.shape[var.dims.index(d)])
            rewritten |= isinstance(conv, slice)
            norm[d] = conv
        else:
            norm[d] = i
    applicable = norm
    if _is_lazy(var.data):
        return var.isel(applicable)
    basic = {d: i for d, i in applicable.items()
             if isinstance(i, (int, np.integer, slice))}
    if basic:
        var = var.isel(basic)
    for d, i in applicable.items():
        if not isinstance(i, (int, np.integer, slice)):
            var = var.isel({d: i})
    if rewritten and isinstance(var.data, np.ndarray) \
            and var.data.base is not None:
        # An array indexer was rewritten to a slice, so this selection is
        # a VIEW where advanced indexing would have returned a copy.
        # Hand out a read-only view: mutating it raises loudly instead of
        # silently writing through to the parent store (which may be an
        # on-disk memmap spill). Reads — the hot path — stay zero-copy.
        guarded = var.data.view()
        guarded.flags.writeable = False
        var = Variable(var.dims, guarded, var.attrs)
    return var


def _broadcast_vars(a: Variable, b: Variable):
    """Align two variables by dim name (union of dims, a's order first)."""
    out_dims = list(a.dims) + [d for d in b.dims if d not in a.dims]
    av = _materialize(a.data)
    bv = _materialize(b.data)
    # Move/insert axes so each matches out_dims.
    a_aligned = _expand_to(av, a.dims, out_dims)
    b_aligned = _expand_to(bv, b.dims, out_dims)
    return out_dims, a_aligned, b_aligned


def _expand_to(values: np.ndarray, dims, out_dims):
    # Transpose existing dims into relative order of out_dims, then insert
    # length-1 axes for missing dims.
    present = [d for d in out_dims if d in dims]
    axes = tuple(dims.index(d) for d in present)
    values = np.transpose(values, axes)
    shape = []
    it = iter(values.shape)
    for d in out_dims:
        shape.append(next(it) if d in dims else 1)
    return values.reshape(shape)


class DataArray:
    """A :class:`Variable` plus the coordinates that share its dims."""

    __slots__ = ("name", "variable", "_coords", "attrs", "_mi")

    def __init__(self, data=None, dims=None, coords=None, name=None, attrs=None,
                 variable=None, mi=None):
        if variable is None:
            if dims is None:
                data = np.asarray(data)
                dims = tuple(f"dim_{i}" for i in range(data.ndim))
            variable = Variable(dims, data, attrs)
        self.variable = variable
        self.name = name
        self.attrs = variable.attrs if attrs is None else dict(attrs)
        self._coords: dict[str, Variable] = {}
        self._mi = dict(mi) if mi else {}
        if coords:
            for cname, cval in coords.items():
                if isinstance(cval, DataArray):
                    self._coords[cname] = cval.variable
                elif isinstance(cval, Variable):
                    self._coords[cname] = cval
                elif isinstance(cval, tuple) and len(cval) == 2 and (
                    isinstance(cval[0], (str, tuple, list))
                ):
                    self._coords[cname] = Variable(cval[0], cval[1])
                else:
                    self._coords[cname] = Variable((cname,), np.asarray(cval))

    # -- introspection --------------------------------------------------------
    @property
    def dims(self):
        return self.variable.dims

    @property
    def shape(self):
        return self.variable.shape

    @property
    def ndim(self):
        return self.variable.ndim

    @property
    def dtype(self):
        return self.variable.dtype

    @property
    def sizes(self):
        return self.variable.sizes

    @property
    def data(self):
        return self.variable.data

    @data.setter
    def data(self, value):
        self.variable = Variable(self.dims, value, self.variable.attrs)

    @property
    def values(self) -> np.ndarray:
        return self.variable.values

    def to_numpy(self) -> np.ndarray:
        return self.variable.values

    def item(self):
        return self.variable.values.item()

    def compute(self) -> "DataArray":
        return self._with(self.variable.compute())

    def copy(self, deep: bool = True) -> "DataArray":
        """A new DataArray; ``deep`` (the xarray default) materializes and
        copies the data into a fresh writable buffer. The snapshot escape
        hatch for constant-stride selections, which return read-only
        zero-copy VIEWS of the parent store (see docs/architecture.md
        "Selection aliasing")."""
        var = (Variable(self.dims, np.array(self.variable.values),
                        dict(self.variable.attrs)) if deep
               else self.variable)
        return self._with(var)

    def persist(self) -> "DataArray":
        return self.compute()

    def chunk(self, *args, **kwargs) -> "DataArray":
        return self

    @property
    def coords(self):
        return {k: self._wrap_coord(k) for k in self._coords}

    def _wrap_coord(self, name) -> "DataArray":
        var = self._coords[name]
        sub = {k: v for k, v in self._coords.items() if set(v.dims) <= set(var.dims)}
        return DataArray(variable=var, name=name, coords=None, mi=self._mi)._set_coords(sub)

    def _set_coords(self, coords):
        self._coords = dict(coords)
        return self

    def __getattr__(self, name):
        # Called only when normal lookup fails; expose coords as attributes.
        coords = object.__getattribute__(self, "_coords")
        if name in coords:
            return self._wrap_coord(name)
        raise AttributeError(name)

    def _with(self, variable, coords=None, mi=None):
        out = DataArray(variable=variable, name=self.name, attrs=self.attrs,
                        mi=self._mi if mi is None else mi)
        out._coords = dict(self._coords if coords is None else coords)
        return out

    def assign_attrs(self, attrs=None, **kw):
        out = self._with(self.variable)
        if attrs:
            out.attrs.update(attrs)
        out.attrs.update(kw)
        return out

    def rename(self, name):
        out = self._with(self.variable)
        out.name = name
        return out

    # -- indexing -------------------------------------------------------------
    def __getitem__(self, key):
        if not isinstance(key, tuple):
            key = (key,)
        # Expand Ellipsis.
        if any(k is Ellipsis for k in key):
            i = key.index(Ellipsis)
            fill = self.ndim - (len(key) - 1)
            key = key[:i] + (slice(None),) * fill + key[i + 1:]
        indexers = dict(zip(self.dims, key))
        return self.isel(**indexers)

    def __setitem__(self, key, value):
        if not isinstance(key, tuple):
            key = (key,)
        if any(k is Ellipsis for k in key):
            i = key.index(Ellipsis)
            fill = self.ndim - (len(key) - 1)
            key = key[:i] + (slice(None),) * fill + key[i + 1:]
        data = self.variable.values
        if isinstance(value, DataArray):
            value = value.values
        data[key] = value
        self.variable = Variable(self.dims, data, self.variable.attrs)

    def isel(self, indexers=None, **kw) -> "DataArray":
        indexers = dict(indexers or {}, **kw)
        var = _isel_var(self.variable, indexers)
        coords = {}
        for cname, cvar in self._coords.items():
            # Coordinates reduced to scalars stay as 0-d variables (xarray
            # keeps scalar coords; so do we).
            coords[cname] = _isel_var(cvar, indexers)
        return self._with(var, coords=coords)

    def sel(self, indexers=None, **kw) -> "DataArray":
        indexers = dict(indexers or {}, **kw)
        iidx = {}
        for d, lab in indexers.items():
            iidx[d] = _label_to_index(self._coords, d, lab)
        return self.isel(**iidx)

    @property
    def loc(self) -> "_LocIndexer":
        return _LocIndexer(self)

    def squeeze(self, dim=None) -> "DataArray":
        if dim is None:
            dims = [d for d, s in self.sizes.items() if s == 1]
        else:
            dims = [dim] if isinstance(dim, str) else list(dim)
        return self.isel(**{d: 0 for d in dims})

    def transpose(self, *order, missing_dims="raise") -> "DataArray":
        order = _resolve_order(order, self.dims, missing_dims)
        var = self.variable.transpose(order)
        return self._with(var)

    def expand_dims(self, dim, axis=0) -> "DataArray":
        if isinstance(dim, str):
            dim = [dim]
        var = self.variable
        for d in dim:
            var = var.expand_dims(d, axis)
        return self._with(var)

    def __iter__(self):
        for i in range(self.shape[0]):
            yield self.isel(**{self.dims[0]: i})

    def __len__(self):
        return self.shape[0]

    # -- math -----------------------------------------------------------------
    def _binop(self, other, op, reflexive=False):
        if isinstance(other, Dataset):
            return NotImplemented
        if isinstance(other, DataArray):
            dims, a, b = _broadcast_vars(self.variable, other.variable)
            out = op(b, a) if reflexive else op(a, b)
            coords = dict(other._coords)
            coords.update(self._coords)
            coords = {k: v for k, v in coords.items() if set(v.dims) <= set(dims)}
            mi = dict(other._mi)
            mi.update(self._mi)
            return DataArray(variable=Variable(tuple(dims), out), name=self.name,
                             mi=mi)._set_coords(coords)
        a = self.variable.values
        b = other
        out = op(b, a) if reflexive else op(a, b)
        return self._with(Variable(self.dims, out))

    def __add__(self, o): return self._binop(o, np.add)
    def __radd__(self, o): return self._binop(o, np.add, True)
    def __sub__(self, o): return self._binop(o, np.subtract)
    def __rsub__(self, o): return self._binop(o, np.subtract, True)
    def __mul__(self, o): return self._binop(o, np.multiply)
    def __rmul__(self, o): return self._binop(o, np.multiply, True)
    def __truediv__(self, o): return self._binop(o, np.divide)
    def __rtruediv__(self, o): return self._binop(o, np.divide, True)
    def __pow__(self, o): return self._binop(o, np.power)
    def __and__(self, o): return self._binop(o, np.logical_and)
    def __rand__(self, o): return self._binop(o, np.logical_and, True)
    def __or__(self, o): return self._binop(o, np.logical_or)
    def __ror__(self, o): return self._binop(o, np.logical_or, True)
    def __invert__(self):
        return self._with(Variable(self.dims, ~self.variable.values))
    def __neg__(self):
        return self._with(Variable(self.dims, -self.variable.values))
    def __gt__(self, o): return self._binop(o, np.greater)
    def __ge__(self, o): return self._binop(o, np.greater_equal)
    def __lt__(self, o): return self._binop(o, np.less)
    def __le__(self, o): return self._binop(o, np.less_equal)
    def __eq__(self, o): return self._binop(o, np.equal)
    def __ne__(self, o): return self._binop(o, np.not_equal)
    __hash__ = None

    def __array__(self, dtype=None, copy=None):
        v = self.variable.values
        return v.astype(dtype) if dtype is not None else v

    def astype(self, dtype) -> "DataArray":
        return self._with(Variable(self.dims, self.variable.values.astype(dtype)))

    def clip(self, min=None, max=None) -> "DataArray":
        return self._with(
            Variable(self.dims, np.clip(self.variable.values, min, max))
        )

    def fillna(self, value) -> "DataArray":
        v = self.variable.values
        if isinstance(value, DataArray):
            dims, a, b = _broadcast_vars(self.variable, value.variable)
            out = np.where(np.isnan(a), b, a)
            return DataArray(variable=Variable(tuple(dims), out), name=self.name,
                             mi=self._mi)._set_coords(self._coords)
        out = np.where(np.isnan(v), value, v)
        return self._with(Variable(self.dims, out))

    def where(self, cond, other=np.nan) -> "DataArray":
        if isinstance(cond, DataArray):
            dims, a, c = _broadcast_vars(self.variable, cond.variable)
        else:
            dims, a, c = self.dims, self.variable.values, np.asarray(cond)
        a = a.astype(float) if a.dtype.kind in "biu" and other is np.nan else a
        out = np.where(c, a, other)
        coords = {k: v for k, v in self._coords.items() if set(v.dims) <= set(dims)}
        return DataArray(variable=Variable(tuple(dims), out), name=self.name,
                         mi=self._mi)._set_coords(coords)

    # -- reductions -----------------------------------------------------------
    def _reduce(self, fn_skipna, fn, dim=None, skipna=None):
        v = self.variable.values
        if dim is None:
            axes = None
            out_dims = ()
        else:
            dims = [dim] if isinstance(dim, str) else list(dim)
            axes = tuple(self.dims.index(d) for d in dims)
            out_dims = tuple(d for d in self.dims if d not in dims)
        if skipna is None:
            skipna = v.dtype.kind == "f"
        fn_use = fn_skipna if skipna else fn
        out = fn_use(v, axis=axes)
        coords = {k: c for k, c in self._coords.items()
                  if set(c.dims) <= set(out_dims)}
        return DataArray(variable=Variable(out_dims, out), name=self.name,
                         mi={k: m for k, m in self._mi.items() if k in out_dims},
                         )._set_coords(coords)

    def sum(self, dim=None, skipna=None, **kw):
        return self._reduce(np.nansum, np.sum, dim, skipna)

    def mean(self, dim=None, skipna=None, **kw):
        return self._reduce(np.nanmean, np.mean, dim, skipna)

    def median(self, dim=None, skipna=None, **kw):
        return self._reduce(np.nanmedian, np.median, dim, skipna)

    def std(self, dim=None, skipna=None, **kw):
        return self._reduce(np.nanstd, np.std, dim, skipna)

    def max(self, dim=None, skipna=None, **kw):
        return self._reduce(np.nanmax, np.max, dim, skipna)

    def min(self, dim=None, skipna=None, **kw):
        return self._reduce(np.nanmin, np.min, dim, skipna)

    def any(self, dim=None, **kw):
        return self._reduce(np.any, np.any, dim, skipna=False)

    def all(self, dim=None, **kw):
        return self._reduce(np.all, np.all, dim, skipna=False)

    # -- reshaping ------------------------------------------------------------
    def stack(self, **kw) -> "DataArray":
        out = self
        for new_dim, dims in kw.items():
            out = _stack_dataarray(out, new_dim, tuple(dims))
        return out

    def unstack(self, dim=None) -> "DataArray":
        ds = Dataset({self.name or "__da__": self})
        ds = ds.unstack(dim)
        out = ds[self.name or "__da__"]
        out.attrs = dict(self.attrs)
        return out

    def groupby(self, name):
        coord = self._coords[name]
        (gdim,) = coord.dims
        vals = coord.values
        uniq = np.unique(vals)
        for u in uniq:
            idx = np.nonzero(vals == u)[0]
            yield u, self.isel(**{gdim: idx})

    def __repr__(self):
        return (f"<magnify_tpu_torch.DataArray {self.name or ''} {self.dims} "
                f"shape={self.shape} dtype={self.dtype}>")


def _resolve_order(order, dims, missing_dims="raise"):
    order = list(order)
    if not order:
        return list(reversed(dims))
    if Ellipsis in order:
        i = order.index(Ellipsis)
        named = [d for d in order if d is not Ellipsis]
        rest = [d for d in dims if d not in named]
        order = order[:i] + rest + order[i + 1:]
        order = [d for d in order if d is not Ellipsis]
    if missing_dims == "ignore":
        order = [d for d in order if d in dims]
        order += [d for d in dims if d not in order]
    else:
        missing = [d for d in order if d not in dims]
        if missing:
            raise ValueError(f"dims {missing} not found in {dims}")
        order += [d for d in dims if d not in order]
    return order


def _label_slice_to_index(vals, label):
    """Label slice -> positional slice (xarray semantics: both endpoints
    inclusive, requires a monotonic coordinate)."""
    diffs = np.diff(vals) if len(vals) > 1 else np.zeros(0)
    if len(diffs) and (diffs >= 0).all():
        asc = vals
        def pos(x, side):
            return int(np.searchsorted(asc, x, side=side))
        start = pos(label.start, "left") if label.start is not None else None
        stop = pos(label.stop, "right") if label.stop is not None else None
    elif len(diffs) and (diffs <= 0).all():
        rev = vals[::-1]
        n = len(vals)
        def rpos(x, side):
            return n - int(np.searchsorted(rev, x, side=side))
        start = rpos(label.start, "right") if label.start is not None else None
        stop = rpos(label.stop, "left") if label.stop is not None else None
    else:
        raise KeyError(
            "label-slice selection needs a monotonic coordinate"
        )
    return slice(start, stop, label.step)


def _label_to_index(coords, dim, label):
    """Convert label-based selection to positional indices using a dim coord."""
    if dim not in coords:
        # No coordinate: treat labels as positions.
        return label
    vals = coords[dim].values
    if isinstance(label, slice):
        return _label_slice_to_index(vals, label)
    if isinstance(label, DataArray):
        label = label.values
    if isinstance(label, (list, np.ndarray)) and not isinstance(label, str):
        idx = []
        for item in np.asarray(label).tolist():
            where = np.nonzero(vals == item)[0]
            if len(where) == 0:
                raise KeyError(f"{item!r} not found in coordinate {dim!r}")
            idx.append(int(where[0]))
        return np.asarray(idx)
    where = np.nonzero(vals == label)[0]
    if len(where) == 0:
        raise KeyError(f"{label!r} not found in coordinate {dim!r}")
    return int(where[0])


class _LocIndexer:
    """``da.loc[...]`` label selection: a dict of dim->label, or positional
    labels applied to leading dims (xarray's DataArray.loc subset)."""

    def __init__(self, da: "DataArray"):
        self._da = da

    def __getitem__(self, key):
        if isinstance(key, dict):
            return self._da.sel(key)
        if not isinstance(key, tuple):
            key = (key,)
        return self._da.sel(dict(zip(self._da.dims, key)))


def _stack_dataarray(da: DataArray, new_dim: str, dims):
    ds = Dataset({da.name or "__da__": da})
    ds = ds.stack(**{new_dim: dims})
    return ds[da.name or "__da__"]


class Dataset:
    """A dict of named :class:`Variable` objects sharing dimensions.

    Mirrors the subset of ``xarray.Dataset`` used by the reference pipelines
    (magnify/pipeline.py and components): variable and
    coordinate assignment, label/positional selection, transposition,
    stack/unstack with multi-index bookkeeping, and attribute access to
    variables.
    """

    __slots__ = ("_vars", "_coord_names", "attrs", "_mi")

    def __init__(self, data_vars=None, coords=None, attrs=None):
        self._vars: dict[str, Variable] = {}
        self._coord_names: set[str] = set()
        self.attrs = dict(attrs) if attrs else {}
        self._mi: dict[str, tuple] = {}  # stacked dim -> (sub_dims, sub_sizes)
        if data_vars:
            for name, val in data_vars.items():
                self[name] = val
        if coords:
            for name, val in coords.items():
                self._assign_coord(name, val)

    # -- construction helpers --------------------------------------------------
    def _coerce(self, name, val) -> Variable:
        if isinstance(val, Variable):
            return val
        if isinstance(val, DataArray):
            for cname, cvar in val._coords.items():
                if cname not in self._vars:
                    self._vars[cname] = cvar
                    self._coord_names.add(cname)
            for k, m in val._mi.items():
                self._mi.setdefault(k, m)
            return val.variable
        if isinstance(val, tuple) and len(val) == 2:
            return Variable(val[0], val[1])
        if isinstance(val, tuple) and len(val) == 3:
            return Variable(val[0], val[1], val[2])
        val = np.asarray(val)
        if val.ndim == 1 and name not in self._vars:
            return Variable((name,), val)
        raise ValueError(f"cannot coerce value for {name!r}")

    def _assign_coord(self, name, val):
        self._vars[name] = self._coerce(name, val)
        self._coord_names.add(name)

    # -- mapping interface -------------------------------------------------------
    def __contains__(self, name):
        return name in self._vars

    def __getitem__(self, name) -> DataArray:
        if name not in self._vars:
            raise KeyError(name)
        var = self._vars[name]
        coords = {
            k: v for k, v in self._vars.items()
            if k in self._coord_names and k != name and set(v.dims) <= set(var.dims)
        }
        mi = {k: m for k, m in self._mi.items() if k in var.dims}
        return DataArray(variable=var, name=name, mi=mi)._set_coords(coords)

    def __setitem__(self, name, val):
        self._vars[name] = self._coerce(name, val)

    def __delitem__(self, name):
        del self._vars[name]
        self._coord_names.discard(name)

    def __getattr__(self, name):
        vars_ = object.__getattribute__(self, "_vars")
        if name in vars_:
            return self[name]
        raise AttributeError(name)

    # -- introspection -----------------------------------------------------------
    @property
    def dims(self):
        out = {}
        for v in self._vars.values():
            for d, s in zip(v.dims, v.shape):
                out[d] = s
        return out

    @property
    def sizes(self):
        return self.dims

    @property
    def data_vars(self):
        return {k: self[k] for k in self._vars if k not in self._coord_names}

    @property
    def coords(self):
        return {k: self[k] for k in self._vars if k in self._coord_names}

    @property
    def variables(self):
        return dict(self._vars)

    def copy(self) -> "Dataset":
        out = Dataset(attrs=self.attrs)
        out._vars = dict(self._vars)
        out._coord_names = set(self._coord_names)
        out._mi = dict(self._mi)
        return out

    def compute(self) -> "Dataset":
        out = self.copy()
        out._vars = {k: v.compute() for k, v in out._vars.items()}
        return out

    def persist(self) -> "Dataset":
        return self.compute()

    # -- assignment ----------------------------------------------------------------
    def assign_coords(self, coords=None, **kw) -> "Dataset":
        out = self.copy()
        for name, val in dict(coords or {}, **kw).items():
            out._assign_coord(name, val)
        return out

    def assign_attrs(self, attrs=None, **kw) -> "Dataset":
        out = self.copy()
        if attrs:
            out.attrs.update(attrs)
        out.attrs.update(kw)
        return out

    def drop_vars(self, names, errors="raise") -> "Dataset":
        names = [names] if isinstance(names, str) else list(names)
        out = self.copy()
        for n in names:
            if n in out._vars:
                del out._vars[n]
                out._coord_names.discard(n)
            elif errors == "raise":
                raise KeyError(n)
        return out

    def rename(self, mapping=None, **kw) -> "Dataset":
        mapping = dict(mapping or {}, **kw)
        out = Dataset(attrs=self.attrs)
        out._mi = {
            mapping.get(k, k): (tuple(mapping.get(d, d) for d in sub), sizes)
            for k, (sub, sizes) in self._mi.items()
        }
        for name, var in self._vars.items():
            new_dims = tuple(mapping.get(d, d) for d in var.dims)
            out._vars[mapping.get(name, name)] = Variable(new_dims, var.data, var.attrs)
        out._coord_names = {mapping.get(n, n) for n in self._coord_names}
        return out

    # -- indexing -------------------------------------------------------------------
    def isel(self, indexers=None, **kw) -> "Dataset":
        indexers = dict(indexers or {}, **kw)
        out = Dataset(attrs=self.attrs)
        out._coord_names = set(self._coord_names)
        out._mi = {k: m for k, m in self._mi.items() if k not in indexers or
                   not isinstance(indexers[k], (int, np.integer))}
        for name, var in self._vars.items():
            out._vars[name] = _isel_var(var, indexers)
        # Coordinates reduced to scalars stay as 0-d variables.
        return out

    def sel(self, indexers=None, **kw) -> "Dataset":
        indexers = dict(indexers or {}, **kw)
        coords = {k: self._vars[k] for k in self._coord_names}
        iidx = {d: _label_to_index(coords, d, lab) for d, lab in indexers.items()}
        return self.isel(**iidx)

    def squeeze(self, dim=None) -> "Dataset":
        if dim is None:
            dims = [d for d, s in self.dims.items() if s == 1]
        else:
            dims = [dim] if isinstance(dim, str) else list(dim)
        return self.isel(**{d: 0 for d in dims})

    def transpose(self, *order, missing_dims="raise") -> "Dataset":
        full = _resolve_order(order, tuple(self.dims), missing_dims="ignore")
        out = self.copy()
        out._vars = {k: v.transpose(full) for k, v in self._vars.items()}
        return out

    # -- stack / unstack ---------------------------------------------------------------
    def stack(self, _mapping=None, create_index=True, **kw) -> "Dataset":
        """Stack dims into a new flat dim, recording the multi-index.

        Mirrors ``assay.stack(mark=("mark_row","mark_col"))`` used after
        button finding (magnify/find.py:182). The stacked
        dim is appended as the last dim of each affected variable (xarray
        semantics); sub-dim coordinates become per-element arrays along the
        stacked dim.
        """
        mapping = dict(_mapping or {}, **kw)
        out = self.copy()
        for new_dim, dims in mapping.items():
            dims = tuple(dims)
            sizes = tuple(out.dims[d] for d in dims)
            n = int(np.prod(sizes))
            new_vars = {}
            for name, var in out._vars.items():
                present = [d for d in dims if d in var.dims]
                if not present:
                    new_vars[name] = var
                    continue
                if len(present) != len(dims):
                    # Broadcast vars carrying a subset of the stacked dims
                    # (e.g. metadata coords along time) across the rest.
                    vals = _materialize(var.data)
                    vdims = list(var.dims)
                    for d in dims:
                        if d not in vdims:
                            vals = np.broadcast_to(
                                vals[..., None], vals.shape + (out.dims[d],)
                            )
                            vdims.append(d)
                    var = Variable(tuple(vdims), np.ascontiguousarray(vals),
                                   var.attrs)
                # Move stacked dims to the end in `dims` order, then merge.
                order = [d for d in var.dims if d not in dims] + list(dims)
                v = var.transpose(order)
                other_shape = v.shape[: v.ndim - len(dims)]
                data = _materialize(v.data).reshape(other_shape + (n,))
                new_vars[name] = Variable(tuple(order[: len(other_shape)]) + (new_dim,),
                                          data, var.attrs)
            # Sub-dim coordinates become arrays along the stacked dim.
            grids = np.meshgrid(*[np.arange(s) for s in sizes], indexing="ij")
            flat = [g.reshape(-1) for g in grids]
            for d, idx in zip(dims, flat):
                if d in out._coord_names and d in new_vars and new_vars[d].dims == (new_dim,):
                    pass  # already reshaped above
                elif d in out._vars and out._vars[d].dims == (d,):
                    vals = _materialize(out._vars[d].data)[idx]
                    new_vars[d] = Variable((new_dim,), vals)
                    out._coord_names.add(d)
                else:
                    new_vars[d] = Variable((new_dim,), idx)
                    out._coord_names.add(d)
            if create_index:
                # Every sub-dim has a coordinate array by now; build the
                # tuple index with one zip instead of a per-element Python
                # loop (a real cost at terabyte-scale mark counts).
                levels = [_materialize(new_vars[d].data).tolist()
                          for d in dims]
                tuples = np.empty(n, dtype=object)
                tuples[:] = list(zip(*levels))
                new_vars[new_dim] = Variable((new_dim,), tuples)
                out._coord_names.add(new_dim)
            out._vars = new_vars
            out._mi[new_dim] = (dims, sizes)
        return out

    def unstack(self, dim=None) -> "Dataset":
        """Reverse :meth:`stack` using the recorded multi-index.

        Unstacked dims are appended at the end of each variable (xarray
        semantics); callers re-``transpose`` as needed, mirroring the chip
        tests' ``xp.unstack().transpose("mark_row", "mark_col", ...)``.
        """
        dims = [dim] if isinstance(dim, str) else (list(self._mi) if dim is None
                                                   else list(dim))
        out = self.copy()
        for sdim in dims:
            if sdim not in out._mi:
                continue
            sub_dims, sub_sizes = out._mi.pop(sdim)
            new_vars = {}
            for name, var in out._vars.items():
                if sdim not in var.dims:
                    new_vars[name] = var
                    continue
                if name == sdim:
                    continue  # drop the tuple-valued multi-index coordinate
                if name in sub_dims and var.dims == (sdim,):
                    # Restore the original 1-d dim coordinate.
                    vals = _materialize(var.data).reshape(sub_sizes)
                    axis = sub_dims.index(name)
                    first = tuple(0 if i != axis else slice(None)
                                  for i in range(len(sub_sizes)))
                    new_vars[name] = Variable((name,), vals[first])
                    continue
                # Move the stacked dim last, then expand.
                order = [d for d in var.dims if d != sdim] + [sdim]
                v = var.transpose(order)
                lead = v.shape[:-1]
                data = _materialize(v.data).reshape(lead + sub_sizes)
                new_vars[name] = Variable(tuple(order[:-1]) + sub_dims, data,
                                          var.attrs)
            out._vars = new_vars
            out._coord_names.discard(sdim)
        return out

    def groupby(self, name):
        """Iterate (label, sub-dataset) groups over a 1-d coordinate."""
        return DataArrayGroupBy(self, name)

    def __repr__(self):
        lines = [f"<magnify_tpu_torch.Dataset> dims={self.dims}"]
        for k, v in self._vars.items():
            tag = "coord" if k in self._coord_names else "var  "
            lines.append(f"  {tag} {k}: {v.dims} {v.dtype}")
        return "\n".join(lines)

    # -- caching (reference: accessor.py `.mg.cache`) -----------------------------
    @property
    def mg(self):
        """Parity shim for the reference's ``.mg`` accessor namespace."""
        return _Accessor(self)

    def cache(self, variables=None) -> "Dataset":
        """Spill lazy variables to an on-disk store and rebind them.

        Mirrors ``MagnifyAccessor.cache`` (magnify/accessor.py:18-35):
        any variable backed by a lazy chunked array is materialized into a
        temporary on-disk store and re-read lazily from there, truncating the
        deferred-op graph.
        """
        from magnify_tpu_torch.core.lazy import (
            ChunkedArray,
            spill_to_store,
            worth_spilling,
        )

        names = ([variables] if isinstance(variables, str)
                 else list(variables) if variables is not None
                 else list(self._vars))
        for name in names:
            var = self._vars[name]
            # Shallow lazy arrays over a large source stay lazy: re-reading
            # them from the source beats writing + re-reading a full copy
            # (measured: the unconditional spill doubled IO and flooded the
            # page cache on a 10.7 GB out-of-core run).
            if isinstance(var.data, ChunkedArray) and worth_spilling(var.data):
                self._vars[name] = Variable(var.dims, spill_to_store(var.data, name),
                                            var.attrs)
        return self


class _Accessor:
    def __init__(self, ds):
        self._ds = ds

    def cache(self, variables=None):
        return self._ds.cache(variables)


class DataArrayGroupBy:
    def __init__(self, ds, name):
        self._ds = ds
        self._name = name

    def __iter__(self):
        coord = self._ds._vars[self._name]
        (gdim,) = coord.dims
        vals = _materialize(coord.data)
        for u in np.unique(vals):
            idx = np.nonzero(vals == u)[0]
            yield u, self._ds.isel(**{gdim: idx})


def concat(objs, dim, **kwargs):
    """Concatenate DataArrays along an existing or new dim (minimal)."""
    objs = list(objs)
    first = objs[0]
    if dim in first.dims:
        axis = first.dims.index(dim)
        data = np.concatenate([o.values for o in objs], axis=axis)
        return first._with(Variable(first.dims, data))
    data = np.stack([o.values for o in objs], axis=0)
    return DataArray(variable=Variable((dim,) + first.dims, data), name=first.name)
