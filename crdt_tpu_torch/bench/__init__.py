"""The port's benchmarks: the rows of ``bench.py`` and the
kernel probes of ``benchmarks/probe_kernel.py`` on the card.

- `data`: the seeded changesets, stress configs and result line;
- `fanin`: the stream replay row (`bench`) and the distinct-batch row
  (`bench_distinct`);
- `probe_kernel`: the probe entry point, ``python -m
  crdt_tpu_torch.bench.probe_kernel``.

The root ``bench.py`` and ``benchmarks/`` import jax; nothing here
imports them.
"""
