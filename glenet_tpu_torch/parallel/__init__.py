"""Training across processes (torch counterpart of glenet_tpu/parallel/):
`distributed` (process groups, result merge, the data-parallel context of
the train step) and `mesh` (the ('data',) and ('data', 'model') meshes and
their train steps)."""
