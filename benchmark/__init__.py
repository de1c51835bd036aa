"""The benchmark of the PyTorch and CUDA port (``attention_based_e2e_asr_dnn_tpu_torch``).

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` on the card and prints one JSON line.
Everything that measures lives here: the traffic generator (``mixes.py``,
fed by ``traffic/<mix>.json``), the weights (``weights.py``), the operation
and byte counts and the peaks (``counts.py``), what depends on a
configuration's architecture (``families/<family>.py``), the trace reduction
(``traces.py``), the per-layer metric readers (``metrics/<metric>.py``), the
plain float32 reference (``reference/``) and the comparison that decides
``correct`` (``checks.py``, limits in ``limits/<cell>.json``).
"""
