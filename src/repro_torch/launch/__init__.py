"""Launchers: ``serve.py``, the serving CLI (``python -m
repro_torch.launch.serve``). Deliberately empty of imports, so that running
a launcher imports only what it needs."""
