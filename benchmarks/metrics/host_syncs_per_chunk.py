"""Host syncs per chunk request: the synchronizing calls that torch.cuda's
sync debug mode reports over the window's engine calls and reads, over the
requests."""

UNIT = "count"
LAYER = "engine"
MOVES = "frames_per_s"


def read(record):
    if record.window.syncs is None:
        return None
    return record.window.syncs / len(record.window.requests)
