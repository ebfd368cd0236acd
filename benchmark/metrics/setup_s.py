"""setup_s: seconds from the process's start to the first timed request:
imports, the CUDA context, the kernel library (built on a checkout's first
run), the chain and one warm request."""


def read(run):
    return run.setup_s
