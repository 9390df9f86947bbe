"""setup_s: from the process's start to the window's first plane (imports,
the CUDA context, the kernel library's load, the plan's tables, init_rays,
the staged planes, the warm-up plane), less the kernels' nvcc build, which
a checkout's first run makes and prints on a line of its own."""


def read(run):
    return run.setup_s
