"""Helpers of the port's tests (``tests/test_torch_*.py``).

The two packages exchange numpy arrays and TSV files and share no class,
so a test that builds an object with one package's helpers and hands it
to the other converts it first, field by field: ``from_reference``.
``plain`` flattens any result (dataclass, object, array, container) into
builtins so results of the two packages compare with ``==``.
"""

import dataclasses

import numpy as np

from freddie_tpu.ops.segdp import DPProblem as RefDPProblem
from freddie_tpu.solver.exact import ClusterInstance as RefClusterInstance
from freddie_tpu.solver.exact import ReadRow as RefReadRow
from freddie_tpu_torch.ops.segdp import DPProblem
from freddie_tpu_torch.solver.exact import ClusterInstance, ReadRow

_FLAT = ("exons_mat", "corr_mat", "garbage_arr", "gap_counts", "gap_lo", "gap_hi",
         "gap_len_arr")


def from_reference(obj):
    """The port's twin of a ``freddie_tpu`` ``DPProblem``, ``ReadRow`` or
    ``ClusterInstance`` (lists of them too), over plain fields and numpy
    arrays; the arrays are shared, not copied."""
    if isinstance(obj, (list, tuple)):
        return type(obj)(from_reference(o) for o in obj)
    if isinstance(obj, RefDPProblem):
        return DPProblem(C=obj.C, y=obj.y, W=obj.W, read_support=obj.read_support, iv=obj.iv)
    if isinstance(obj, RefReadRow):
        return ReadRow(exons=obj.exons, corr=obj.corr, garbage=obj.garbage,
                       gaps=list(obj.gaps))
    if isinstance(obj, RefClusterInstance):
        lazy = obj.__dict__.get("_rows_store") is None and obj.exons_mat is not None
        return ClusterInstance(
            rows=None if lazy else from_reference(list(obj.rows)),
            seg_len=obj.seg_len, incomp=obj.incomp, epsilon=obj.epsilon, offset=obj.offset,
            **{name: getattr(obj, name) for name in _FLAT},
        )
    raise TypeError(f"no port twin for {type(obj).__name__}")


def plain(obj):
    """obj as nested builtins: arrays become (dtype kind, shape, list),
    objects their class name and fields, in a stable order."""
    if isinstance(obj, np.ndarray):
        return ("array", obj.dtype.kind, obj.shape, obj.tolist())
    if isinstance(obj, np.generic):
        return obj.item()
    if isinstance(obj, dict):
        return {plain(k): plain(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [plain(o) for o in obj]
    if isinstance(obj, tuple):
        return tuple(plain(o) for o in obj)
    if isinstance(obj, (set, frozenset)):
        return sorted(plain(o) for o in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return (type(obj).__name__,
                {f.name: plain(getattr(obj, f.name)) for f in dataclasses.fields(obj)})
    if hasattr(obj, "__dict__") and not callable(obj):
        return (type(obj).__name__, {k: plain(v) for k, v in sorted(vars(obj).items())})
    return obj
