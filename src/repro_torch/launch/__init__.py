"""Launchers: ``mesh.py`` (production meshes), ``steps.py`` (the cell
builder), ``dryrun.py`` (the dry run over a fake process group), ``train.py``
and ``serve.py`` (the CLIs, ``python -m repro_torch.launch.train|serve|
dryrun``). Deliberately empty of imports, so that running a launcher
imports only what it needs."""
