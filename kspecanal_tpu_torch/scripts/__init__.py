"""Performance-forensics scripts of the port, run on the card:

    python -m kspecanal_tpu_torch.scripts.roofline_r2 [--fft N] [--f32-sums] [T ...]
    python -m kspecanal_tpu_torch.scripts.kernel_ablate [fft] [u8|f32] [T_lo T_hi]
    python -m kspecanal_tpu_torch.scripts.session_ablate [k]

Each ``main(argv)`` prints its table and returns its numbers."""
