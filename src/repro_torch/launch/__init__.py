"""Launchers: the training CLI (port of `repro.launch`; its meshes, dry run
and serving CLI wait for ROADMAP.md item A.6)."""
