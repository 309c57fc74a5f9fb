"""The port's example scripts: the counterparts of the JAX package's
examples/ (the reference's parity binaries; README.md here).

    python -m gpuntt_tpu_torch.examples.<name> [LOGN] [BATCH] [--device=cuda|cpu]

Each prints `All Correct.` (or the JAX script's failure word) and exits
0 or 1.  The device examples run on the first CUDA card unless
`--device=cpu` or GPUNTT_DEVICE=cpu asks for the host (_device.py);
each splits into `compute(logn, batch, device)`, which returns the
arrays it checks, and `main(argv=None)`, which checks them against the
golden models.
"""
