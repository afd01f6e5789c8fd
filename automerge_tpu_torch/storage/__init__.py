"""Storage layer: chunk framing, the change and document chunks'
columnar codecs, and the ARSN run image (``runsnap.py``)."""
