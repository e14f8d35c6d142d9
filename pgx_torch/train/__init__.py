"""Growth schedules, the train step, the sampling function and the training
loop of the port."""

from pgx_torch.train.schedule import (  # noqa: F401
    LegacySchedule,
    ProperSchedule,
    ScheduleState,
    schedule_from_dict,
)
from pgx_torch.train.wgan import (  # noqa: F401
    TrainConfig,
    draw_augment_sources,
    draw_z_eps,
    init_train_state,
    make_eval_generate,
    make_train_multi_step,
    make_train_step,
    train_state_from_jax,
)
from pgx_torch.train.loop import LoopConfig, train_loop  # noqa: F401,E402
