"""The paper's experiment on the port: traces captured from the port's own
training steps, fed to the cost model of the paper's accelerator, and the
paper's tables (``python -m repro_torch.benchmarks.run``)."""
