"""The document layer: the op store (``op_store.py``), clocks and the
change graph, marks, the Document (``document.py``) with its bulk
rebuild and stale reads on the merge kernels (``bulk_load.py``), and
transactions (``transaction.py``)."""
