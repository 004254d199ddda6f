"""Plain references: ``demuxnet.py``, DemuxNet and the classify stream's
arithmetic in PyTorch, importing nothing of the port."""
