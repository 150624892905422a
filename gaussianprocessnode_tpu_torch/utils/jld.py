"""Reader for the reference's golden JLD artifacts (savefiles/*.jld).

Counterpart of ``gaussianprocessnode_tpu/utils/jld.py`` (numpy and h5py;
the port keeps its own copy, as it does of the dataset loaders).

JLD is HDF5 with Julia conventions: plain arrays are datasets; vectors of
vectors are object arrays of references into ``_refs``; composite types
(e.g. MvNormalMeanCovariance) are compound scalars whose fields are
references. This covers exactly the shapes the reference saves
(SURVEY.md §2.8) — enough to seed parity tests against the recorded
posteriors, optima and metrics.
"""

import numpy as np

__all__ = ["load_jld"]


def _resolve(h5file, obj):
    import h5py

    if isinstance(obj, h5py.Reference):
        return _materialize(h5file, h5file[obj])
    return obj


def _materialize(h5file, ds):
    import h5py

    if isinstance(ds, h5py.Group):
        return {k: _materialize(h5file, v) for k, v in ds.items()}
    val = ds[()]
    return _convert(h5file, val)


def _convert(h5file, val):
    import h5py

    if isinstance(val, h5py.Reference):
        return _materialize(h5file, h5file[val])
    if isinstance(val, np.void):  # compound (Julia struct): dict of fields
        return {name: _convert(h5file, val[name]) for name in val.dtype.names}
    if isinstance(val, np.ndarray):
        if val.dtype == object or val.dtype.kind == "O":
            out = [_convert(h5file, v) for v in val.ravel()]
            try:
                return np.asarray(out).reshape(val.shape + np.asarray(out[0]).shape)
            except Exception:
                return out
        if val.dtype.names:  # compound array
            return [
                {n: _convert(h5file, row[n]) for n in val.dtype.names} for row in val.ravel()
            ]
        # Julia writes column-major; h5py yields the transposed view for 2-D
        return val.T if val.ndim == 2 else val
    return val


def load_jld(path: str, key: str | None = None):
    """Load a JLD file; returns the single user variable (or dict of them).

    Julia structs come back as dicts of their fields (e.g. an
    MvNormalMeanCovariance → {'μ_': mean, 'Σ_': cov})."""
    import h5py

    with h5py.File(path, "r") as h:
        keys = [k for k in h.keys() if k not in ("_creator", "_refs", "_types")]
        if key is not None:
            return _materialize(h, h[key])
        if len(keys) == 1:
            return _materialize(h, h[keys[0]])
        return {k: _materialize(h, h[k]) for k in keys}
