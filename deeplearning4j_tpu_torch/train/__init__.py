"""Training: the eleven updaters and nine learning-rate schedules, K steps
a dispatch (``train.stepping``), the model archive
(``train.serializer``), checkpoints, resume, preemption and NaN recovery
(``train.resilience``), the listeners (``train.listeners``) and early
stopping (``train.earlystopping``)."""
