"""capture_gib: GiB the first ``run`` call adds to the allocator's peak
over what was allocated before it (the step's buffers and the graph's
pool), the largest over the cards."""


def read(rec):
    return rec.capture_gib if rec.peak_bytes is not None else None
