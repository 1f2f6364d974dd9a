"""kernels.join_host_ms: the time, in ms a merge, of the port's
``crdt_tpu_torch.fanin.join`` span: the fan-in kernel's host cost (its
checks, output allocations and launch)."""

from crdtbench import program_spans


def read(out):
    return program_spans.per_merge_ms([program_spans.JOIN])
