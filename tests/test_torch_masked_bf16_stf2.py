"""``stf2`` under the bfloat16 activation policy against JAX's: the tests
of ``test_torch_masked.MaskedBf16Twin`` on a narrow twin (2 slices, mask
window 2, 3 sliding tokens: 8 tokens of D = 128), one training step
against each of JAX's forwards (unrolled and ``scan_tokens``), in a file
of its own so that the suite's workers run the twins side by side."""

from test_torch_masked import MaskedBf16Twin


class TestStf2Bf16(MaskedBf16Twin):
    name = "stf2"
    config = {"num_slices": 2, "mask_win_size": 2, "num_sliding": 3}

    def test_scan_tokens_train_step_bf16_matches_jax_bf16(self, twin, monkeypatch):
        """The step of ``test_train_step_bf16_matches_jax_bf16`` against JAX's
        ``scan_tokens=True`` forward."""
        self._train_step(twin, "scan_tokens", monkeypatch)
