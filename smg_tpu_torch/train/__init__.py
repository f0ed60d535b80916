from smg_tpu_torch.train.leader import MeshTrainState, RankPool, gather_state, leaf_norms
from smg_tpu_torch.train.step import AdamWState, TrainState, make_train_step

__all__ = ["AdamWState", "MeshTrainState", "RankPool", "TrainState", "gather_state",
           "leaf_norms", "make_train_step"]
