"""model.merge_span_ms: the mean time, in ms, of the port's own
``crdt_tpu_torch.merge`` span, the whole of one ``DenseCrdt.merge_many``
call, timed by the program while the profiler records (the inside twin
of ``model.host_ms_per_merge``)."""

from crdtbench import program_spans


def read(out):
    return program_spans.per_merge_ms([program_spans.MERGE])
