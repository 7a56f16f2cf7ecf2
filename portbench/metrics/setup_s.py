"""Process start to the hand-off of the window's first frame, in seconds:
imports and CUDA initialisation, the kernel library, the world, and the
warm-up frames with their graph captures."""


def read(rec):
    return rec["setup_s"]
