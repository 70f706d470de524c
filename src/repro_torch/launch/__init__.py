"""Launchers: training, serving and the production mesh (port of
`repro.launch`: training and serving under the production meshes, every
family; the specs and the dry run wait for ROADMAP.md item A.6c)."""
