"""Training and serving of the port: AdamW (:mod:`.optimizer`), the train
step and :class:`Trainer` (:mod:`.train_loop`) and the server
(:mod:`.serve`)."""
from .optimizer import OptState, adamw_init, adamw_update, lr_schedule
from .train_loop import Trainer, make_train_step
from .serve import Server, greedy_generate
