"""Set-up seconds: from the process's start to the window's (imports, CUDA,
K1's build or load, the plans, the executables, the payloads, the
warm-up)."""


def read(rec):
    return rec.setup_s
