"""model.prepare_ms: the time, in ms a merge, of the port's
``crdt_tpu_torch.merge.prepare`` span: the host's lane handling ahead
of the dispatch (ingest drain, id interning, slot fit, ordinal encode,
the concat, the GC fence)."""

from crdtbench import program_spans


def read(out):
    return program_spans.per_merge_ms([program_spans.PREPARE])
