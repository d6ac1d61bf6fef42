"""Render the port's dry-run table from experiments/dryrun_torch/*.json
(written by ``python -m repro_torch.launch.dryrun``). Every number is
reckoned from the specs, the shapes and the card's rates; nothing was
compiled. ``GiB/dev`` and ``fit`` are the reference's layout; ``port``
and ``pfit`` the port's own step on as many ranks (``-`` where the port
cannot run the cell), ``p_x ms`` its collective term.

    python experiments/print_table_torch.py
"""
import glob
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))


def main(directory: str = os.path.join(HERE, "dryrun_torch")) -> int:
    rows, failed = [], []
    for p in sorted(glob.glob(os.path.join(directory, "*.json"))):
        with open(p) as f:
            r = json.load(f)
        (rows if r.get("ok") else failed).append(r)
    hdr = (f"{'arch':22s} {'shape':12s} {'mesh':8s} {'GiB/dev':>8s} "
           f"{'fit':>3s} {'dom':>10s} {'t_c ms':>10s} {'t_m ms':>9s} "
           f"{'t_x ms':>10s} {'useful':>6s} {'mb':>2s} {'port':>8s} "
           f"{'pfit':>4s} {'p_x ms':>10s}")
    print(hdr)
    print("-" * len(hdr))
    for r in sorted(rows, key=lambda r: (r["arch"], r["shape"], r["mesh"])):
        p = r["port"]
        own = (f"{p['hbm_gib']:8.2f} {'Y' if p['fits'] else 'N':>4s} "
               f"{p['collective_s'] * 1e3:10.2f}" if p["runs"]
               else f"{'-':>8s} {'-':>4s} {'-':>10s}")
        print(f"{r['arch']:22s} {r['shape']:12s} {r['mesh']:8s} "
              f"{r['hbm_gib']:8.2f} {'Y' if r['fits_hbm'] else 'N':>3s} "
              f"{r['dominant']:>10s} {r['compute_s'] * 1e3:10.2f} "
              f"{r['memory_s'] * 1e3:9.2f} {r['collective_s'] * 1e3:10.2f} "
              f"{r['useful_flops_ratio']:6.3f} {r['microbatches']:>2d} {own}")

    def cells(keep):
        return [f"{r['arch']}/{r['shape']}/{r['mesh']}" for r in rows
                if keep(r)] or "none"

    print(f"\ncells: {len(rows)} reckoned, {len(failed)} failed; not "
          f"fitting: {cells(lambda r: not r['fits_hbm'])}; the port's step "
          f"not fitting: {cells(lambda r: r['port']['runs'] and not r['port']['fits'])}"
          f"; the port cannot run: {cells(lambda r: not r['port']['runs'])}")
    for r in failed:
        print(f"FAILED {r['arch']}/{r['shape']}/{r['mesh']}: {r['error']}")
    return 0 if not failed else 1


if __name__ == "__main__":
    raise SystemExit(main())
