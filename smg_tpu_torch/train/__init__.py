from smg_tpu_torch.train.step import AdamWState, TrainState, make_train_step

__all__ = ["AdamWState", "TrainState", "make_train_step"]
