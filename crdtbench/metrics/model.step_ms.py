"""model.step_ms: the time, in ms a merge, of the port's
``crdt_tpu_torch.fanin.mask`` and ``crdt_tpu_torch.fanin.stamp`` spans:
the host cost of the ``seen`` count and of the eager ops around the
join (the stamp, the pipelined tail and its send bump)."""

from crdtbench import program_spans


def read(out):
    return program_spans.per_merge_ms([program_spans.MASK,
                                       program_spans.STAMP])
