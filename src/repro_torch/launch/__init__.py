"""repro_torch.launch — the training driver (`python -m
repro_torch.launch.train`), the join executor's mesh of ranks
(`launch.mesh.make_join_mesh`, with the card's roofline rates), and the
dry run (`python -m repro_torch.launch.dryrun`) with its op analysis
(`launch.op_analysis`)."""
