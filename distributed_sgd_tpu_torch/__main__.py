"""``python -m distributed_sgd_tpu_torch``: the dev sync scenario on the card."""

from distributed_sgd_tpu_torch.main import main

main()
