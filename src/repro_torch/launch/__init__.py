"""Launch layer of the port: the command-line trainers (`train_gbdt`, the LM
`train`), the mesh builder, the GBDT dry run and the LM's sharded dry run
(`specs`, `partition`, `dryrun`)."""
