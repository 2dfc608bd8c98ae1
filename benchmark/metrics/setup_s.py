"""setup_s: from the process's start to the first timed iteration:
imports, CUDA set-up, the kernels' build or load, the inputs, the
program's preparation of the graph, upload, the first steps and one
warm-up fit (host clock)."""


def read(rec):
    return rec.get("setup_s")
