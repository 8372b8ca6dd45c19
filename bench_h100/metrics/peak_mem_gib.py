"""peak_mem_gib: the process's highest torch.cuda.max_memory_allocated
over the run's cards, set-up included, in GiB; read by the benchmark from
the allocator before the reference runs."""


def read(rec):
    return None if rec.peak_bytes is None else rec.peak_bytes / 2 ** 30
