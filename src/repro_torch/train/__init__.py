"""LoRA fine-tuning: losses, the step factories and the scheduler-driven
elastic trainer."""
from repro_torch.train.elastic import (ElasticReport, ElasticTrainer,
                                       SlotLog)
from repro_torch.train.losses import (cross_entropy, lm_loss,
                                      masked_prediction_loss, task_loss)
from repro_torch.train.step import (apply_grads, init_opt_state,
                                    make_decode_step, make_eval_step,
                                    make_grad_step, make_prefill_step,
                                    make_train_step)

__all__ = ["ElasticReport", "ElasticTrainer", "SlotLog", "apply_grads", "cross_entropy", "init_opt_state", "lm_loss",
           "make_decode_step", "make_eval_step", "make_grad_step",
           "make_prefill_step", "make_train_step", "masked_prediction_loss",
           "task_loss"]
