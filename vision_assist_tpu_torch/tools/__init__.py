"""Tools of the port, each run as
``python -m vision_assist_tpu_torch.tools.<name>`` with ``main(argv)``:
``compare_pathfinders`` (whether the engines' paths agree), and ``_card``,
what the tools and the kernel profilers share. The port is measured by the
benchmark, ``benchmark/run.py``."""
