"""Serving: the web demo's WSGI app (``server.py``) on the stdlib server of
``wsgi.py``, and the pipeline's MJPEG live monitor (``monitor.py``)."""
