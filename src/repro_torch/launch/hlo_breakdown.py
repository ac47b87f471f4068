"""Per-operation byte breakdown of one cell's traced step.

Counterpart of ``repro.launch.hlo_breakdown``; the name is kept so that a
reader finds it, but it reads no HLO: the port has no compiler.  It traces
one step of the cell cut to ``--layers`` layers
(:func:`repro_torch.launch.dryrun_lib.trace_cell` on the production mesh)
and sums the per-device result bytes and the calls of every aten operation
(and of every collective ``sharding/comm.py`` issues) into the reference's
groups: which class of operation owns the memory term (matrix products?
elementwise chains? dtype conversions? collectives?).  A view is counted
as a call with no bytes: it moves none.  An operation outside the groups
keeps its own name, as in the reference.

    PYTHONPATH=src python -m repro_torch.launch.hlo_breakdown --cell llama3_405b:train_4k
"""

import argparse
import collections
from typing import Dict, Tuple

_GROUPS = {
    "matmul": ("mm", "bmm", "addmm", "baddbmm", "convolution",
               "_scaled_dot_product_flash_attention", "_scaled_dot_product_efficient_attention"),
    "elementwise": ("add", "mul", "sub", "rsub", "div", "neg", "exp", "log", "tanh",
                    "sigmoid", "rsqrt", "sqrt", "pow", "sin", "cos", "silu", "gelu", "relu",
                    "softplus", "clamp", "where", "eq", "ne", "lt", "le", "gt", "ge",
                    "remainder", "bitwise_and", "bitwise_or", "logical_and", "logical_not",
                    "maximum", "minimum", "abs", "tril", "gelu_backward", "silu_backward",
                    "sigmoid_backward", "tanh_backward", "softplus_backward",
                    "threshold_backward", "masked_fill"),
    "convert": ("_to_copy",),
    "layout": ("view", "_unsafe_view", "reshape", "t", "transpose", "permute", "expand",
               "clone", "copy", "cat", "stack", "split", "split_with_sizes", "unbind",
               "squeeze", "unsqueeze", "select", "slice", "flip", "alias", "detach",
               "select_backward", "slice_backward", "as_strided"),
    "reduce": ("sum", "mean", "amax", "amin", "max", "min", "argmax", "cumsum", "logsumexp",
               "_softmax", "_softmax_backward_data", "_log_softmax",
               "_log_softmax_backward_data", "var_mean"),
    "collective": ("all-gather", "reduce-scatter", "all-reduce", "all-to-all"),
    "scatter/gather": ("index", "index_put", "gather", "scatter", "scatter_add",
                       "index_select", "index_add", "embedding", "embedding_dense_backward"),
    "io": ("empty", "empty_like", "empty_strided", "zeros", "zeros_like", "ones",
           "ones_like", "full", "full_like", "arange", "new_zeros", "new_empty",
           "scalar_tensor", "fill", "zero"),
}
# aten operation name (an in-place form's trailing "_" dropped) -> group
GROUPS = {op: grp for grp, ops in _GROUPS.items() for op in ops}


def breakdown(trace) -> Tuple[collections.Counter, collections.Counter]:
    """(result bytes, calls) by group of a
    :class:`~repro_torch.launch.dryrun_lib.Trace`."""
    bytes_by: collections.Counter = collections.Counter()
    count_by: collections.Counter = collections.Counter()
    for op, n in trace.calls.items():
        grp = GROUPS.get(op.rstrip("_") if op not in GROUPS else op, op)
        bytes_by[grp] += trace.result_bytes[op]
        count_by[grp] += n
    return bytes_by, count_by


def cell_breakdown(arch: str, shape: str, layers: int = 2, multi_pod: bool = False) -> Dict:
    """The traced step of ``arch`` at ``shape`` cut to ``layers`` layers on
    the production mesh: ``{"bytes", "calls", "trace"}``."""
    import repro_torch.configs as configs
    from repro_torch.launch.dryrun_lib import _reduced, production_mesh, trace_cell

    cfg = _reduced(configs.get(arch), layers)
    got = trace_cell(cfg, configs.SHAPES[shape], production_mesh(multi_pod=multi_pod))
    b, c = breakdown(got["trace"])
    return {"bytes": b, "calls": c, "trace": got["trace"]}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", required=True)
    ap.add_argument("--layers", type=int, default=2)
    args = ap.parse_args()

    arch, shape = args.cell.split(":")
    got = cell_breakdown(arch, shape, args.layers)
    b, c = got["bytes"], got["calls"]
    total = sum(b.values())
    print(f"{arch}:{shape} (L={args.layers} traced, per-device result bytes)")
    for grp, by in b.most_common():
        print(f"  {grp:16s} {by/1e9:9.2f} GB ({100*by/total:5.1f}%)  x{c[grp]}")


if __name__ == "__main__":
    main()
