"""The benchmark of tpu-operator's PyTorch and CUDA port (``tpu_operator_torch``).

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once; see README.md.
"""
