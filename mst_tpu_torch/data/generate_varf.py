"""The variation-factor table (counterpart of mst_tpu/data/generate_varf.py;
reference utils/generate_varf.py).

    python -m mst_tpu_torch.data.generate_varf --raw_data_dir ... \
        --raw_data_filename ... [--varf avg_vel ...] [--varf_path out.pkl]
"""

import argparse
import os

from mst_tpu_torch.data.trajectories import get_varf_table


def main(argv=None):
    import pandas as pd

    parser = argparse.ArgumentParser()
    parser.add_argument("--additional_data_dir", default="data/sdd/raw")
    parser.add_argument("--raw_data_dir", default=None, type=str)
    parser.add_argument("--raw_data_filename", default=None, type=str)
    parser.add_argument("--varf_path", default=None, type=str)
    parser.add_argument("--obs_len", default=8, type=int)
    parser.add_argument("--varf", default=["avg_vel"], nargs="+")
    args = parser.parse_args(argv)

    df = pd.read_pickle(
        os.path.join(args.raw_data_dir, args.raw_data_filename))
    df_varfs = get_varf_table(df, args.varf, args.obs_len)
    out_path = args.varf_path or os.path.join(args.additional_data_dir,
                                              "df_varfs.pkl")
    df_varfs.to_pickle(out_path)
    print(f"Saved variation factor data to {out_path}")


if __name__ == "__main__":
    main()
