"""model.syncs_per_merge: the host-device syncs the port counted under
its ``crdt_tpu_torch.merge`` span and every span the merge step opens
inside it (``crdt_tpu_span_syncs_total``), a merge span. A pipelined
merge promises none."""

from crdtbench import program_spans


def read(out):
    got = program_spans.spans()
    merges = got.get(program_spans.MERGE, [0])[0]
    if not merges:
        return None
    return sum(got[n][2] for n in program_spans.IN_MERGE
               if n in got) / merges
