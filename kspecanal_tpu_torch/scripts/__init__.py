"""Performance-forensics scripts of the port, run on the card:

    python -m kspecanal_tpu_torch.scripts.roofline_r2 [--fft N] [--f32-sums] [T ...]
    python -m kspecanal_tpu_torch.scripts.kernel_ablate [fft] [u8|f32] [T_lo T_hi]
    python -m kspecanal_tpu_torch.scripts.session_ablate [k]
    python -m kspecanal_tpu_torch.scripts.threemult_smoke [--blocks B] [--forms]
    python -m kspecanal_tpu_torch.scripts.tc_stages [FFT:NONO:WINDOW:T:PREC ...]

and the sharded paths' scripts (worlds of ranks, ``parallel/spawn.py``;
``collective_bytes`` is host code):

    python -m kspecanal_tpu_torch.scripts.dryrun_multichip [S] [--share-card]
    python -m kspecanal_tpu_torch.scripts.scaling_bench [fft] [blocks_per_rank]
    python -m kspecanal_tpu_torch.scripts.collective_bytes [S]

Each ``main(argv)`` prints its table and returns its numbers."""
