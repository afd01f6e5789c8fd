"""Document-model types the port's read API returns (``marks.Mark``)."""
