"""TimeRFT data filtering and sampling from the command line (port of
`time_r1_tpu/cli/process_data.py`, the reference's src/utils/process_data.py).

    python -m time_r1_tpu_torch.cli.process_data --input_json merged.json \
        -t 0070_all|gaussian_03|random_sample [-k 2500] [-o PREFIX]
"""

from __future__ import annotations

import argparse

from ..utils.curriculum import process_data_file


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--input_json")
    p.add_argument("-o", "--output_prefix", default="")
    p.add_argument("-t", "--task", default="", choices=["0070_all", "gaussian_03", "random_sample"])
    p.add_argument("-k", "--k_dynamic_total", default=2500, type=int)
    args = p.parse_args(argv)
    if not args.output_prefix:
        args.output_prefix = args.input_json[:-5]
    out = process_data_file(args.input_json, args.output_prefix, args.task, int(args.k_dynamic_total))
    print(f"save to: {out}")


if __name__ == "__main__":
    main()
