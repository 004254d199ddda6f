"""``setup_s``: seconds from the start of the process to the window's:
imports, the card's context, the corpus, the models, the kernel build or
load, the reader pool, the warm-up and the stream's first pass."""


def read(record):
    return record.setup_s
