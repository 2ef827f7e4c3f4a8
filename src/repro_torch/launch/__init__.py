"""Launch layer of the port: the command-line trainer (`train_gbdt`)."""
