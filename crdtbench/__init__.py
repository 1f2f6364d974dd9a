"""The benchmark of the PyTorch and CUDA port (`crdt_tpu_torch`).

One run of one cell: ``python3 crdtbench/run.py --workload <name>
--seed <n> --seconds <s> --trace <0|1>``. Everything that belongs to a
configuration, a traffic mix or a metric lives in a file of its own
(``configs/``, ``workloads/``, ``traffic/``, ``metrics/``), found by
the name that ``BENCHMARK.json`` and the workload files give.
"""
