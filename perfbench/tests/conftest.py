import pytest
import torch


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none (decided when a test asks)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return "cuda"
