"""The variation-factor filter (counterpart of mst_tpu/data/filter_dataset.py;
reference utils/filter_dataset.py).

Two modes:

* table mode (the reference CLI surface, used by the preprocessing
  pipelines): filter against a precomputed varf pkl with optional
  one-sided bounds, writing `<data>_filter.pkl` next to the input —
  python -m mst_tpu_torch.data.filter_dataset --data_path car.pkl \
      --varf_path varf_8_12_2_5fps.pkl --lower_bound 0.2
* recompute mode (no --varf_path): derive the stats from the data —
  python -m mst_tpu_torch.data.filter_dataset --data_path in.pkl \
      --varf avg_vel --lower 0.5 --upper 3.5 [--out_path out.pkl]
"""

import argparse

from mst_tpu_torch.data.splits import (filter_by_varf_table,
                                       filter_dataset_by_varf)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_path", required=True)
    parser.add_argument("--out_path", default=None,
                        help="default: <data_path>_filter.pkl")
    # table mode (reference filter_dataset.py:21-34 flag surface)
    parser.add_argument("--varf_path", default=None,
                        help="precomputed varf pkl; enables table mode")
    parser.add_argument("--factor", default="avg_vel")
    parser.add_argument("--lower_bound", default=None, type=float)
    parser.add_argument("--upper_bound", default=None, type=float)
    # recompute mode
    parser.add_argument("--varf", default="avg_vel")
    parser.add_argument("--lower", type=float, default=None)
    parser.add_argument("--upper", type=float, default=None)
    parser.add_argument("--obs_len", default=None, type=int)
    args = parser.parse_args(argv)

    if args.out_path is None:
        if not args.data_path.endswith(".pkl"):
            parser.error("--data_path must end in .pkl to derive the default "
                         "output path; pass --out_path explicitly otherwise")
        out_path = args.data_path[:-len(".pkl")] + "_filter.pkl"
    else:
        out_path = args.out_path
    if args.varf_path is not None:
        # The two modes share a parser; reject recompute-only flags in table
        # mode instead of silently ignoring them (e.g. --lower vs --lower_bound).
        bad = [name for name, val, default in
               (("--lower", args.lower, None), ("--upper", args.upper, None),
                ("--obs_len", args.obs_len, None), ("--varf", args.varf, "avg_vel"))
               if val != default]
        if bad:
            parser.error("table mode (--varf_path) uses --lower_bound/"
                         "--upper_bound/--factor; got recompute-mode flag(s): "
                         + ", ".join(bad))
        df = filter_by_varf_table(args.data_path, args.varf_path,
                                  args.lower_bound, args.upper_bound,
                                  args.factor, out_path)
    else:
        if args.lower is None or args.upper is None:
            parser.error("recompute mode (no --varf_path) requires "
                         "--lower and --upper")
        df = filter_dataset_by_varf(args.data_path, out_path, args.varf,
                                    args.lower, args.upper, args.obs_len)
    print(f"Filtered {df.metaId.nunique()} trajectories -> {out_path}")


if __name__ == "__main__":
    main()
