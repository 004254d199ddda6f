"""The benchmark of ``deepbinner_tpu_torch``: pod5 files in, call rows out.

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once; see
``benchmark/README.md``.  Nothing under this directory imports ``jax``,
``jaxlib``, ``flax`` or the JAX package ``deepbinner_tpu``; the plain
reference (``references/``), the corpus generator (``kits.py``,
``sim.py``, ``pod5w.py``, ``corpus.py``) and the operation counts
(``flops.py``) import nothing of ``deepbinner_tpu_torch`` either.
"""
