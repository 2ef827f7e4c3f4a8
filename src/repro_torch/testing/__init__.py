"""Testing utilities shipped with the package: the fault-injection harness
(`repro_torch.testing.faults`), counterpart of `repro.testing`, which the
resilience tests and `chip_smoke.py` use to drive the resilience layer."""
