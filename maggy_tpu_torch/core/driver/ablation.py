"""Ablation-study driver: the port's copy of :mod:`maggy_tpu.core.driver.ablation`.

Capability parity with the reference ``AblationDriver``
(core/experiment_driver/ablation_driver.py:32-208): reuses the HPO driver's
entire scheduling/RPC machinery with a LOCO controller and no early stopping
(the reference forces NoStoppingRule, ablation_driver.py:52). Per-trial model
and dataset variants are resolved on the worker via the study's generators —
the factory replacement for the reference's Keras-JSON layer surgery.

A torch module holds its weights, so unlike the JAX driver's, every trial's
model is new: the factory's, a custom generator's, or a build from the
config model's config on its device (:mod:`maggy_tpu_torch.ablation.masking`);
the config model itself never reaches a train_fn, so no trial trains what a
later one derives its variant from.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

from maggy_tpu_torch.ablation.ablationstudy import AblationStudy, default_dataset_generator
from maggy_tpu_torch.ablation.ablator import LOCO, AbstractAblator
from maggy_tpu_torch.config.hpo import HyperparameterOptConfig
from maggy_tpu_torch.core.driver.hpo import HyperparameterOptDriver
from maggy_tpu_torch.core.executors.trial import trial_executor_fn
from maggy_tpu_torch.optimizer.abstractoptimizer import AbstractOptimizer
from maggy_tpu_torch.searchspace import Searchspace
from maggy_tpu_torch.trial import Trial


class AblatorController(AbstractOptimizer):
    """Adapter exposing an AbstractAblator through the optimizer interface the
    driver polls (reference ablation_driver.py:144-151 controller_get_next)."""

    def __init__(self, ablator: AbstractAblator, **kwargs):
        super().__init__(**kwargs)
        self.ablator = ablator

    def initialize(self) -> None:
        self.ablator.final_store = self.final_store
        self.ablator.initialize()

    def get_suggestion(self, trial: Optional[Trial] = None) -> Union[Trial, str, None]:
        return self.ablator.get_trial(trial)

    def finalize_experiment(self, trials) -> None:
        self.ablator.finalize_experiment(trials)

    def name(self) -> str:
        return type(self.ablator).__name__


def _make_ablator(config) -> AbstractAblator:
    if isinstance(config.ablator, AbstractAblator):
        return config.ablator
    if isinstance(config.ablator, str):
        if config.ablator.lower() == "loco":
            return LOCO(config.ablation_study)
        raise ValueError(f"Unknown ablator {config.ablator!r}; expected 'loco'")
    if isinstance(config.ablator, type) and issubclass(config.ablator, AbstractAblator):
        return config.ablator(config.ablation_study)
    raise TypeError(f"ablator must be a name or AbstractAblator, got {config.ablator!r}")


class AblationDriver(HyperparameterOptDriver):
    def __init__(self, config, app_id: str, run_id: int):
        if not isinstance(config.ablation_study, AblationStudy):
            raise TypeError("AblationConfig.ablation_study must be an AblationStudy")
        self.study = config.ablation_study
        ablator = _make_ablator(config)
        hpo_config = HyperparameterOptConfig(
            num_trials=ablator.get_number_of_trials(),
            optimizer=AblatorController(ablator),
            searchspace=Searchspace(),
            optimization_key=config.optimization_key,
            direction=config.direction,
            es_policy="none",  # reference forces NoStoppingRule (ablation_driver.py:52)
            es_min=2**31,
            name=config.name,
            description=config.description,
            hb_interval=config.hb_interval,
            model=config.model,
            dataset=config.dataset,
            num_executors=config.num_executors,
            devices_per_trial=config.devices_per_trial,
            log_dir=config.log_dir,
            sharding=config.sharding,
            driver_addr=getattr(config, "driver_addr", None),
            worker_timeout=getattr(config, "worker_timeout", 600.0),
            trial_retries=getattr(config, "trial_retries", 2),
            retry_backoff=getattr(config, "retry_backoff", 0.5),
            quarantine_after=getattr(config, "quarantine_after", 3),
            quarantine_cooldown=getattr(config, "quarantine_cooldown", 300.0),
            device=getattr(config, "device", None),
        )
        super().__init__(hpo_config, app_id, run_id)

    # ------------------------------------------------------------------ executor

    def _resolver(self):
        return make_ablation_resolver(self.study)

    def _executor_fn(self, train_fn: Callable, partition_id: int, devices: list) -> Callable:
        return trial_executor_fn(
            train_fn=train_fn,
            config=self.config,
            app_id=self.app_id,
            run_id=self.run_id,
            partition_id=partition_id,
            server_addr=(self.server.host, self.server.port),
            secret=self.server.secret,
            devices=devices,
            resolve=self._resolver(),
        )


def make_ablation_resolver(study):
    """Trial-params -> train_fn-kwargs resolver for ablation trials. Module
    level so pod trial workers — which hold the same AblationConfig the
    driver does — can rebuild it host-side (core/pod.py run_trial_worker).
    It runs on the trial's executor thread with the lease's card current."""
    dataset_generator = study.dataset_generator or default_dataset_generator

    def resolve(params, available):
        feature = params.get("ablated_feature")
        component = params.get("ablated_component")
        feature = None if feature in (None, "None") else feature
        component = None if component in (None, "None") else component

        available = dict(available)
        available["ablated_feature"] = feature
        available["ablated_component"] = component
        # the markers ride dedicated kwargs; hparams stays clean so train_fns
        # that splat it into config constructors remain oblivious
        available["hparams"] = {
            k: v
            for k, v in available["hparams"].items()
            if k not in ("ablated_feature", "ablated_component")
        }
        available["dataset"] = dataset_generator(available["dataset"], feature)

        if component is not None and component.startswith("custom:"):
            name = component[len("custom:"):]
            available["model"] = study.model.custom_generators[name]()
        elif study.model.factory is not None:
            ablated = (
                frozenset() if component is None else frozenset(component.split("|"))
            )
            available["model"] = study.model.factory(ablated)
        elif component is not None:
            # factory-free path (reference parity: any model, zero
            # plumbing — loco.py:82-136): derive the variant from the
            # config model via config.without()/ablated-field rebuild, or
            # generic parameter masking
            from maggy_tpu_torch.ablation.masking import auto_ablate

            base = available.get("model")
            if base is None:
                raise ValueError(
                    f"Trial ablates component {component!r} but the study "
                    "has no model factory and the config has no model; "
                    "pass AblationConfig(model=...) or call "
                    "study.model.set_factory(fn)."
                )
            available["model"] = auto_ablate(
                base, frozenset(component.split("|"))
            )
        else:
            # the baseline and the feature trials: the config model anew
            from maggy_tpu_torch.ablation.masking import fresh

            available["model"] = fresh(available.get("model"))
        return available

    return resolve
