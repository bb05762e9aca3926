"""The plain reference of one GMMVI step, frozen with the benchmark.

A copy of the plain PyTorch modules that ``gmmvi_tpu_torch``'s step runs
for one process and one card at D <= 128 (models, ops, optimization, the
planar-robot targets; the mesh reductions, MORE and the large-D routes
left out), with their imports rewritten to this package and every
kernel wrapper cut down to its plain version:
nothing here launches a hand-written kernel or imports ``jax``,
``gmmvi_tpu`` or ``gmmvi_tpu_torch``.  The docstrings are the originals';
where they speak of kernels on the card, read the plain version.
``portbench/check.py`` drives it stage by stage to judge the program's
step, and a later change to the program never changes it.
"""
