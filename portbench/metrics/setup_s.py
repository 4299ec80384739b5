"""``setup_s``: host seconds from the process's start to the window's start
(CUDA init, the kernel library, the model's load or the Scene's prepare,
the warm events)."""


def read(rec):
    return rec.setup_s
