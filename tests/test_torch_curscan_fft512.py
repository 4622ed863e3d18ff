"""Port parity of the curscan kernel's plain version at fft 512 (fft 256 and
2048 are in their own files, so each file stays short): against the JAX
Pallas kernel in interpret mode and the JAX XLA chain, over both overlaps
(aligned 0.5 and misaligned 0.1), every cumulate mode and both input
types.  Bounds in ``torch_parity.assert_spectra_close``."""
import pytest

from torch_parity import MODES, check_grid_case


@pytest.mark.parametrize("u8", [False, True], ids=["f32", "u8"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("nono", [0.5, 0.1])
def test_plain_matches_jax_kernel_and_chain(nono, mode, u8):
    check_grid_case(512, nono, mode, u8)
