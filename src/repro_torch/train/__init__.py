from .step import TrainState, build_train_step, make_train_state
