"""The benchmark of ``repro_torch`` on one NVIDIA H100 (see README.md).

Everything that measures and judges the program lives here: the traffic
generator, the plain references, the roofline arithmetic, the per-layer
readers and the comparison that decides ``correct``.  The program under
test is imported only by ``adapters/`` and ``drivers/``.
"""
