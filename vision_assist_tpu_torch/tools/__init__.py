"""Measurement tools of the port, each run as
``python -m vision_assist_tpu_torch.tools.<name>`` with ``main(argv)``; the
counterparts of the repository's tools/ that measure the JAX package."""
