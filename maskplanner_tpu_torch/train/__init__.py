"""Training: the step, the LR milestones and the loss-weight curriculum."""
from .schedulers import (PSACDScheduler, apply_delayed_activations,
                         lr_milestones, make_lr_scheduler)
from .trainer import (batch_to_device, build_loss_batch, eval_step,
                      make_optimizer, train_step)
