"""Multi-device execution over ``torch.distributed``: the ('data', 'model')
device mesh, sharded detection, the sharded part chain, the dp×tp train
step of the learned detector, and the multi-device dry run."""
