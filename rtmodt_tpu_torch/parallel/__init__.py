"""Several cards and several streams: the device mesh and its ranks
(``mesh.py``, with the shared rank targets in ``ranks.py``) and S camera
streams split over the ranks (``multistream.py``)."""
