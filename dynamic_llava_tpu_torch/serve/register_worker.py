"""Manually (re)register a model worker with a controller: the port's own
copy of ``dynamic_llava_tpu/serve/register_worker.py``.

Useful when a worker came up before its controller, or after a controller
restart wiped the registry.
"""

from __future__ import annotations

import argparse

import requests


def register(controller_address: str, worker_name: str,
             check_heart_beat: bool = True) -> None:
    resp = requests.post(
        controller_address + "/register_worker",
        json={
            "worker_name": worker_name,
            "check_heart_beat": check_heart_beat,
            "worker_status": None,
        },
    )
    resp.raise_for_status()


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--controller-address", type=str, required=True)
    parser.add_argument("--worker-name", type=str, required=True)
    parser.add_argument("--check-heart-beat", action="store_true")
    args = parser.parse_args(argv)
    register(args.controller_address, args.worker_name, args.check_heart_beat)


if __name__ == "__main__":
    main()
