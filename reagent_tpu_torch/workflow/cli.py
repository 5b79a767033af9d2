"""The ``reagent`` CLI: run any workflow entry point from YAML.

Port of ``reagent_tpu/workflow/cli.py`` (reference:
reagent/workflow/cli.py:20-94) — ``reagent run module.func cfg.yaml``
synthesizes the config class from the function signature and calls it::

    python -m reagent_tpu_torch.workflow.cli run \
        reagent_tpu_torch.workflow.gym_batch_rl.offline_gym_random \
        reagent_tpu_torch/workflow/sample_configs/discrete_dqn_cartpole_offline.yaml \
        --extra-options '{"env_name": "CartPole-v1", ...}'

The port's entry points take ``device`` (default ``"cuda"``), which a config
or ``--extra-options`` may set like any other argument.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import logging
import sys

import click
import yaml

from reagent_tpu_torch.core.configuration import config_class_for, kwargs_from_config


def _setup_logging(verbose: bool) -> None:
    logging.basicConfig(
        stream=sys.stderr,
        level=logging.DEBUG if verbose else logging.INFO,
        format="%(asctime)s %(levelname).1s %(name)s:%(lineno)d] %(message)s",
    )


def _resolve(workflow: str):
    module_name, func_name = workflow.rsplit(".", 1)
    module = importlib.import_module(module_name)
    return getattr(module, func_name)


@click.group()
def reagent() -> None:
    """ReAgent-TPU CLI (the PyTorch port)"""


@reagent.command(short_help="Run the workflow with config file")
@click.argument("workflow")
@click.argument("config_file", type=click.File("r"))
@click.option("--extra-options", default=None)
@click.option("--verbose", is_flag=True)
def run(workflow: str, config_file, extra_options, verbose) -> None:
    """Reference cli.py:63-82."""
    _setup_logging(verbose)
    from reagent_tpu_torch.core import debug_on_error

    debug_on_error.start()  # reference cli.py:22-24
    func = _resolve(workflow)
    config = yaml.safe_load(config_file) or {}
    if extra_options:
        config.update(json.loads(extra_options))
    result = func(**kwargs_from_config(func, config))
    if result is not None:
        click.echo(str(result))


@reagent.command(short_help="Print JSON-schema of the workflow")
@click.argument("workflow")
def print_schema(workflow: str) -> None:
    """Reference cli.py:85-94."""
    func = _resolve(workflow)
    cfg_cls = config_class_for(func)
    schema = {
        "title": cfg_cls.__name__,
        "type": "object",
        "properties": {
            f.name: {"default": None if f.default is dataclasses.MISSING else str(f.default)}
            for f in dataclasses.fields(cfg_cls)
        },
    }
    click.echo(json.dumps(schema, indent=2))


if __name__ == "__main__":
    reagent()
