"""GiB of device memory at the window's peak
(``torch.cuda.max_memory_allocated`` after a reset at its start)."""


def read(rec):
    if not rec["peak_bytes"]:
        return None
    return rec["peak_bytes"] / 2 ** 30
