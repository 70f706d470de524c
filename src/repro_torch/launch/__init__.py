"""Launchers: training, serving and the production mesh (port of
`repro.launch`; training under a mesh waits for ROADMAP.md item A.6b, the
specs and the dry run for A.6c)."""
