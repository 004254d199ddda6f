"""Port of deepbinner_tpu.native: the C++ fast5 reader and the C vbz unpacker."""
