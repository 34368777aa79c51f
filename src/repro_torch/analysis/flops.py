"""Dispatch-level FLOP / HBM-traffic / collective counting — port of
``repro/analysis/flops.py``.

The reference walks a jaxpr; the port runs the step under a
``TorchDispatchMode`` and counts every aten op as it runs, so a Python loop
is counted as often as it turns (the reference's scan multiplier comes for
free) and ``torch.utils.checkpoint``'s recompute shows up in the backward,
as remat's does in a jaxpr.  On fake inputs (``FakeTensorMode``) nothing is
computed or allocated: the dry-run's arrangement.

Conventions (the reference's):
- ``flops``: matrix products and convolutions only, 2·M·N·K — ``mm``,
  ``bmm``, ``addmm``, ``baddbmm``, ``convolution``, and what ``einsum``,
  ``matmul`` and ``linear`` decompose into.
- ``hbm_bytes``: an unfused traffic model — every op's output bytes, plus
  the operand bytes of data-moving and contracting ops (products, gathers,
  scatters, reductions, arg-reductions, sorts, cumulative ops, slicing
  copies; ``_CONTRACTING``).  Views and allocations without a write
  (``empty``) cost nothing.  A hand-written kernel's launch
  (``kernels.common.run_kernel``) counts as one data-moving op: its
  operands and outputs, the tensors it writes in place among both.

On a mesh the mode sees each ``DTensor`` op at its global shape, as the
reference counts the global jaxpr; the dry-run divides by the chips.  The
ops of a ``local_map`` region, forward and backward, run on one rank's
shard: they are counted ``kernels.common.STEP.ranks`` times (the ranks that
run the region), so the count stays global.  The reference counts a
``shard_map`` body once, at one shard's shape: on a cell whose step runs
such a region (the MoE exchange, the sharded cache ops) the two
conventions differ by design.  The local
copies of an explicit ``redistribute`` are counted at their local shape.

Collectives — those DTensor's redistributions issue below the mode, those
inside ``local_map`` regions, functional (``_c10d_functional``) and
in-place (``c10d``) alike — go to ``collectives``: one ``(kind, result
bytes, group size)`` a collective run, per device, which
``roofline.collective_bytes`` weights.

``peak_bytes`` is the most bytes of tensor storage alive at once while
``fn`` ran (one rank's shards on a mesh), counting the storage of the
arguments; the dry-run's temp bytes come from it.
"""
from __future__ import annotations

import weakref
from typing import Any, Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.kernels import common

__all__ = ["count_fn", "Counter"]

_aten = torch.ops.aten

_PRODUCTS = {_aten.mm.default, _aten.bmm.default, _aten.addmm.default, _aten.baddbmm.default,
             _aten.convolution.default}

# the aten counterparts of the reference's _CONTRACTING (flops.py:28-33),
# besides the products: gathers, scatters, reductions, arg-reductions,
# sorts, cumulative ops and slicing copies
_CONTRACTING_NAMES = {
    "gather", "index", "index_select", "embedding", "take", "take_along_dim",
    "scatter", "scatter_", "scatter_add", "scatter_add_", "scatter_reduce", "scatter_reduce_",
    "index_put", "index_put_", "_index_put_impl_", "index_add", "index_add_", "index_copy",
    "index_copy_", "index_fill", "index_fill_", "masked_scatter", "masked_scatter_",
    "embedding_dense_backward", "sum", "mean", "amax", "amin", "max", "min", "prod", "any",
    "all", "logsumexp", "argmax", "argmin", "sort", "topk", "cumsum", "cumsum_", "cumprod",
    "cummax", "cummin", "logcumsumexp", "_softmax", "_log_softmax", "_softmax_backward_data",
    "_log_softmax_backward_data", "nll_loss_forward", "nll_loss_backward", "var", "var_mean",
    "norm", "linalg_vector_norm", "copy_", "slice_scatter", "select_scatter", "narrow_copy",
    "diagonal_scatter", "as_strided_scatter",
}
# allocations that write nothing
_FREE_NAMES = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
               "lift_fresh", "detach", "alias", "_local_scalar_dense", "wait_tensor", "set_",
               "resize_", "record_stream", "_wrap_tensor_autograd"}

_COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather", "allgather_": "all-gather",
    "_allgather_base_": "all-gather", "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
    "shard_dim_alltoall": "all-to-all",  # DTensor's shard-to-shard redistribution
}
_COLLECTIVE_NS = ("_c10d_functional", "c10d", "_c10d_functional_autograd", "_dtensor")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list[torch.Tensor]:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _is_dtensor_type(types) -> bool:
    from torch.distributed.tensor import DTensor

    return any(issubclass(t, DTensor) for t in types)


def _product_flops(func, args, out) -> int:
    if func is _aten.mm.default:
        (m, k), n = args[0].shape, args[1].shape[1]
        return 2 * m * n * k
    if func is _aten.addmm.default:
        (m, k), n = args[1].shape, args[2].shape[1]
        return 2 * m * n * k
    if func is _aten.bmm.default:
        (b, m, k), n = args[0].shape, args[1].shape[2]
        return 2 * b * m * n * k
    if func is _aten.baddbmm.default:
        (b, m, k), n = args[1].shape, args[2].shape[2]
        return 2 * b * m * n * k
    # convolution(input, weight, ...): 2 x (in-channels/groups x kernel) an output element
    weight = args[1]
    return 2 * out.numel() * (weight.numel() // max(weight.shape[0], 1))


def _group_size(func, args, kwargs) -> int:
    """The ranks of a collective's group: a funcol op names its group, a
    c10d op carries the process group object."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    ns = func.namespace
    if ns.startswith("_c10d_functional") or ns == "_dtensor":
        for a in (*args, *kwargs.values()):
            if isinstance(a, str) and a not in ("sum", "avg", "max", "min", "product"):
                try:
                    return _resolve_process_group(a).size()
                except (ValueError, RuntimeError, KeyError):
                    continue
        sizes = [a for a in args if isinstance(a, int) and not isinstance(a, bool)]
        return sizes[0] if sizes else 1
    for a in (*args, *kwargs.values()):
        if isinstance(a, torch.ScriptObject):
            try:
                return dist.ProcessGroup.unbox(a).size()
            except (RuntimeError, TypeError):
                continue
    return 1


class Counter:
    """What one ``count_fn`` run saw.  ``ops`` (with ``trace=True``): one
    ``(op, input shapes, flops, bytes)`` an op counted."""

    def __init__(self, trace: bool = False, formulas=None):
        self.formulas = formulas
        self.flops = 0.0
        self.hbm_bytes = 0.0
        self.collectives: list[tuple[str, int, int]] = []
        self.notes: list[str] = []
        self.ops: list[tuple] | None = [] if trace else None
        self.live = 0
        self.peak = 0
        self._seen: dict[int, int] = {}
        self._fake_mode = None  # the step's, from its first fake tensor

    # -- live storage -------------------------------------------------------
    def track(self, tensors) -> None:
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor

        for t in tensors:
            if isinstance(t, DTensor):  # one rank's shard
                t = t._local_tensor
            if t.device.type == "meta":  # a shape, no storage
                continue
            if isinstance(t, FakeTensor):
                # DTensor's sharding propagation makes global-shape fakes of
                # its own, in a fake mode of its own: not the step's memory
                if self._fake_mode is None:
                    self._fake_mode = t.fake_mode
                elif t.fake_mode is not self._fake_mode:
                    continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self._seen:
                continue
            n = st.nbytes()
            self._seen[key] = n
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live -= self._seen.pop(key, 0)

    # -- costs --------------------------------------------------------------
    def add(self, name: str, shapes, flops: float, byts: float) -> None:
        self.flops += flops
        self.hbm_bytes += byts
        if self.ops is not None:
            self.ops.append((name, shapes, flops, byts))

    def op(self, func, args, kwargs, out, scale: int | None = None) -> None:
        """One aten op; ``scale``: how many ranks run it (by default
        ``kernels.common.STEP.ranks``; 1 for a ``DTensor`` op, counted at
        its global shape)."""
        name = func._overloadpacket.__name__
        if func.namespace in _COLLECTIVE_NS:
            kind = _COLLECTIVES.get(name)
            if kind is not None:
                outs = _tensors(out) or _tensors(args[:1])
                self.collectives.append((kind, sum(_nbytes(t) for t in outs),
                                         _group_size(func, args, kwargs)))
            elif name not in _FREE_NAMES:
                self.notes.append(f"collective {name} not weighted")
            return
        if func.is_view or name in _FREE_NAMES or func.namespace == "prim":
            return
        scale = common.STEP.ranks if scale is None else scale
        if self.formulas is not None:
            self.formulas(func, args, kwargs, out, scale)
        outs = _tensors(out)
        byts = sum(_nbytes(t) for t in outs)
        flops = 0
        if func in _PRODUCTS:
            flops = _product_flops(func, args, out)
            byts += sum(_nbytes(t) for t in _tensors((args, kwargs)))
        elif name in _CONTRACTING_NAMES:
            byts += sum(_nbytes(t) for t in _tensors((args, kwargs)))
        self.add(str(func), [tuple(t.shape) for t in _tensors(args)], scale * flops, scale * byts)

    def kernel(self, name: str, inputs, outputs) -> None:
        """A hand-written kernel's launch: one data-moving op."""
        scale = common.STEP.ranks
        byts = sum(_nbytes(t) for t in (*inputs, *outputs))
        self.add(f"kernel.{name}", [tuple(t.shape) for t in inputs], 0, scale * byts)

    def result(self) -> dict[str, Any]:
        out = {"flops": self.flops, "hbm_bytes": self.hbm_bytes, "notes": sorted(set(self.notes)),
               "collectives": list(self.collectives), "peak_bytes": self.peak}
        if self.ops is not None:
            out["ops"] = self.ops
        return out


class _CommsOnly(TorchDispatchMode):
    """Beneath a ``DTensor`` op: its local ops' storage and the collectives
    of its redistributions, not their costs (the op was counted once, at
    its global shape)."""

    def __init__(self, counter: Counter):
        super().__init__()
        self.c = counter

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _is_dtensor_type(types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if isinstance(func, torch._ops.OpOverload) and func.namespace in _COLLECTIVE_NS:
            self.c.op(func, args, kwargs, out)
        self.c.track(_tensors(out))
        return out


class _CountMode(TorchDispatchMode):
    def __init__(self, counter: Counter):
        super().__init__()
        self.c = counter

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not isinstance(func, torch._ops.OpOverload):  # higher-order ops
            return func(*args, **kwargs)
        if common.STEP.rules:  # a kernel's shape rule
            out = func(*args, **kwargs)
            self.c.track(_tensors(out))
            return out
        if _is_dtensor_type(types):  # counted at its global shape
            # DTensor's sharding propagation builds small index tensors of
            # its own (a strided shard's local size) and reads them on the
            # host: they must be real, so no fake mode is active while it
            # runs; the shards, fake tensors, still dispatch as fakes
            from torch._subclasses.fake_tensor import unset_fake_temporarily

            with unset_fake_temporarily(), _CommsOnly(self.c):
                out = func(*args, **kwargs)
            self.c.op(func, args, kwargs, out, scale=1)
        else:
            out = func(*args, **kwargs)
            self.c.op(func, args, kwargs, out)
        self.c.track(_tensors(out))
        return out


def count_fn(fn: Callable, *args, trace: bool = False, formulas=None, **kwargs) -> dict[str, Any]:
    """Run ``fn(*args, **kwargs)`` under the counting mode →
    ``{"flops", "hbm_bytes", "notes", "collectives", "peak_bytes"}`` (and
    ``"ops"`` with ``trace``), plus ``"result"``: what ``fn`` returned.
    ``formulas(func, args, kwargs, out, scale)``, where given, sees every
    op counted (a second opinion on the FLOPs)."""
    c = Counter(trace, formulas)
    c.track(_tensors((args, kwargs)))
    prev, common.STEP.kernel = common.STEP.kernel, c.kernel
    try:
        with _CountMode(c):
            res = fn(*args, **kwargs)
    finally:
        common.STEP.kernel = prev
    out = c.result()
    out["result"] = res
    return out
