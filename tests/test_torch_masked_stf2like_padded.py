"""The stf2 narrow twin with mask window 3 and 4 sliding tokens: the 8 x 8
latent padded to 9 x 9, 18 tokens of D = 72, y_hat cropped after the merge;
the tests of ``test_torch_masked_stf2.Stf2Twin``, in a file of their own so
that the suite's workers run the twins side by side."""

from test_torch_masked_stf2 import Stf2Twin


class TestStf2LikePadded(Stf2Twin):
    config = {"mask_win_size": 3, "num_sliding": 4}
