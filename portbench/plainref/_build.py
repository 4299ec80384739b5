"""The kernel library's place in the frozen copy: it has none. Every
wrapper of the copy runs its plain PyTorch version for CPU tensors, and the
benchmark hands the copy CPU tensors only, so nothing here is ever reached."""


def _no_kernels(*_a, **_k):
    raise RuntimeError("plainref is the plain reference: it builds and launches no kernel")


library = bind = check = stream_ptr = _no_kernels
