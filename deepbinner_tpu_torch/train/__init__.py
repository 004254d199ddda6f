"""Port of deepbinner_tpu.train: prep → balance → train."""
