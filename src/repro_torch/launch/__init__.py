"""Launchers: ``mesh.py`` (production meshes), ``steps.py`` (the cell
builder), ``train.py`` and ``serve.py`` (the CLIs, ``python -m
repro_torch.launch.train|serve``). Deliberately empty of imports, so that
running a launcher imports only what it needs."""
