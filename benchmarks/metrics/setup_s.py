"""Set-up: from the process's start to the window's start (imports, CUDA
initialisation, the kernel libraries' build or load, the traffic rendered
on the card, the engine made and every distinct sequence run once)."""

UNIT = "s"
LAYER = "end to end"


def read(record):
    return record.setup_s
