"""setup_s: seconds from the start of the run to the opening of its window
(imports, CUDA start-up, the kernel library's load or build, the scene, the
BVH build, the traffic and the warm-up)."""


def read(r):
    return r.setup_s
