"""Share of the traced window in which no operation (kernel, copy or
set) ran on the card, from torch.profiler's CUDA activity."""


def read(run):
    rec = run.record
    busy = rec.device_busy() if rec is not None else None
    if not busy or not busy[1]:
        return None
    return 100.0 * (1.0 - busy[0] / busy[1])
