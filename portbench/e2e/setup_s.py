"""setup_s (s): from the first line of run.py to the window's start:
imports, the CUDA context, the scene, the host build and its upload,
the ray batches, the build or load of the program's kernels, and a
warm-up call on every batch."""


def read(window):
    return window.setup_s
