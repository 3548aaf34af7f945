"""The benchmark of ``fslr_tpu_torch``: ``python3 -m benchmark.run``.

It drives the port only; nothing under this folder imports ``jax`` or
``fslr_tpu``, and the comparison that decides ``correct`` (``judge.py``
over ``gen.py``'s planted truth) imports nothing of the port either.
"""
