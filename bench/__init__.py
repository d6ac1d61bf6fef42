"""The benchmark of the PyTorch and CUDA port (``repro_torch``) on one H100.

``python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell of ``BENCHMARK.json`` (at the repository root). The
harness is driven by data; each piece is found by the name the cell gives:

* ``configs/<config>.json``  a deployment: generator, scale, shape, source;
* ``generators/<name>.py``   ``generate(config, seed, device)``, on the card;
* ``traffic/<mix>.json``     the entry point, its arguments, the loop;
* ``adapters/<name>.py``     ``prepare(graph, traffic, device)``: the call;
* ``loops/<name>.py``        ``run(call, seconds, keep)``: the window;
* ``end_to_end/<metric>.py`` ``read(window)``: a metric of ``--trace 0``;
* ``metrics/<metric>.py``    ``read(record)``: a per-layer metric of
  ``--trace 1``, from the reduced profiler trace;
* ``reference/<name>.py``    the plain check that decides ``correct``.

Nothing here imports ``jax`` or the JAX package ``repro``, and nothing
under ``reference/`` imports the port.
"""
