"""Launch layer of the port: the command-line trainers (`train_gbdt`, the LM
`train`), the mesh builder and the GBDT dry run."""
