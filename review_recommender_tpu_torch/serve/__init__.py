"""HTTP serving: the stdlib front end with the micro-batcher (api.py), the
C++ epoll front end (native_server.py) and the web page (ui.py)."""
