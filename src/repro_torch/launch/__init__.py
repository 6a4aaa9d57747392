"""repro_torch.launch — the training driver (`python -m
repro_torch.launch.train`) and the join executor's mesh of ranks
(`launch.mesh.make_join_mesh`)."""
