"""Several camera streams on one card (``multistream.py``)."""
