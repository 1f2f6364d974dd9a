"""model.fence_wait_ms: the mean time, in ms, of the port's
``crdt_tpu_torch.window.fence`` span: a ``pipelined()`` window's end,
its one readback (the host waiting for the device's backlog) and the
flag report."""

from crdtbench import program_spans


def read(out):
    got = program_spans.spans()
    if program_spans.FENCE not in got:
        return None
    count, seconds, _ = got[program_spans.FENCE]
    return 1e3 * seconds / count
