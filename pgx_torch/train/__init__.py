"""Growth schedules and the sampling function of the port."""

from pgx_torch.train.schedule import (  # noqa: F401
    LegacySchedule,
    ProperSchedule,
    ScheduleState,
    schedule_from_dict,
)
from pgx_torch.train.wgan import make_eval_generate  # noqa: F401
