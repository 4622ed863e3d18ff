"""Performance-forensics scripts of the port, run on the card:

    python -m kspecanal_tpu_torch.scripts.roofline_r2 [--fft N] [--precision P] [T ...]
    python -m kspecanal_tpu_torch.scripts.kernel_ablate [fft] [prec] [u8|f32] [T_lo T_hi]
    python -m kspecanal_tpu_torch.scripts.session_ablate [k]
    python -m kspecanal_tpu_torch.scripts.session_file_ablate [n_iters] [catch_up]
    python -m kspecanal_tpu_torch.scripts.qfs_ablate [--bands B] [--sweeps K]
    python -m kspecanal_tpu_torch.scripts.fm_ablate [--fft N] [--sweeps S]
    python -m kspecanal_tpu_torch.scripts.probe_membw [T ...]
    python -m kspecanal_tpu_torch.scripts.perf_followup [small|precision|all]
    python -m kspecanal_tpu_torch.scripts.perf_r2 [ovl90|small]
    python -m kspecanal_tpu_torch.scripts.perf_probe [fft ...]
    python -m kspecanal_tpu_torch.scripts.threemult_smoke [--blocks B] [--forms]
    python -m kspecanal_tpu_torch.scripts.tc_stages [FFT:NONO:WINDOW:T:PREC ...]
    python -m kspecanal_tpu_torch.scripts.packed_tc_stages [--kernel-only]
    python -m kspecanal_tpu_torch.scripts.mixed_stages [--nono X] [FFT:T ...]
    python -m kspecanal_tpu_torch.scripts.fft_stages [--parent | --versus-parent [--kernel-only] | --staging] [CELL ...]
    python -m kspecanal_tpu_torch.scripts.packed_stages [--parent | --versus-parent [--kernel-only]] [CELL ...]

the sharded paths' scripts (worlds of ranks, ``parallel/spawn.py``;
``collective_bytes`` is host code):

    python -m kspecanal_tpu_torch.scripts.dryrun_multichip [S] [--share-card]
    python -m kspecanal_tpu_torch.scripts.scaling_bench [fft] [blocks_per_rank]
    python -m kspecanal_tpu_torch.scripts.collective_bytes [S]

and two that need no card: ``make_fixture out.iq [numSamples] [centerFreq]
[gain]`` writes an rtl_sdr capture of the synth's tones, ``render_demo
[out.png] [--device cpu]`` renders a demo session to PNG (matplotlib).

Each ``main(argv)`` prints its table and returns its numbers."""
