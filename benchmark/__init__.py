"""The benchmark of ``emqx_tpu_torch``, the PyTorch and CUDA broker core.

One run drives one cell of ``BENCHMARK.json`` (a deployment under a
traffic mix) through the port's served publish path and prints one JSON
line; ``python3 -m benchmark.run --help`` lists the arguments. Everything
the harness needs to know about a deployment, a traffic mix or a
per-layer metric sits in a file of its own, found by the name that
``BENCHMARK.json`` gives it:

- ``benchmark/configs/<config>.json``: the deployment (filter classes,
  counts, tree shape, the guarantees it states);
- ``benchmark/traffic/<traffic>.json``: the traffic mix (draw law,
  publishers, window of PUBLISHes in flight, payload);
- ``benchmark/metrics/<metric>.py``: the reader of one per-layer metric.

Nothing here imports JAX or the JAX package; ``reference.py`` imports
nothing of the port either.
"""
