"""Port of ``scripts/real_data_rehearsal.py``: the Day-0 real-data rehearsal,
raw Kaggle-schema monthly CSVs through every entry point to a REST answer
(``scripts/real_data_rehearsal.json``).

Stages, each with the script's assertion:

0. ``fabricate``: five monthly CSVs (``2019-Oct.csv`` .. ``2020-Feb.csv``)
   in the Kaggle "eCommerce Events History in Cosmetics Shop" schema
   (``KAGGLE_COLUMNS``: 9 columns, RFC-4180 quoted commas in ``brand`` and
   ``category_code``, UUID sessions), drawn with the script's numpy draws
   in the script's order and written in pandas' ``to_csv`` dialect with
   the ``csv`` module; skipped with ``--raw-dir``, the real dump's path;
1. ``concat``: the files globbed and concatenated into one CSV under one
   header (for the fabricated files, the bytes of pandas'
   ``concat(read_csv(f) for f in files).to_csv(index=False)``);
2. ``cli.eda`` (``--item-col product_id``: statistics, an HTML profile,
   the ``user_item_event.csv`` projection);
3. ``cli.preprocess --scheme v1`` (weights in (0, 1]);
4. ``cli.train`` (dim 32, 3 layers, 5 epochs; ``--quick``: dim 16, 2
   layers, 2 epochs), run inside ``--work``, where its relative
   ``data/prepared`` and ``model-checkpoints`` land;
5. ``cli.infer --max-path-users 50``;
6. one predict round trip through ``make_server`` and the batcher on the
   best checkpoint's service: 20 items for the sampler's first user.

The sessions come from ``uuid.uuid4()``, unseeded, as in the script; no
stage reads them. Every file goes under ``--work`` (files of an earlier
run there are overwritten) and the line to ``--out``. The line has the
script's keys plus ``EXTRA_KEYS``: the card, the kernels' launches by
stage (only the service's refresh launches one: K1 f32) and the bars
(``bars.real_data_rehearsal``: the TPU file's counts exactly and its
best val R@20 within 0.02 where the run is the TPU's, 1,000,000
fabricated rows and the full training; 20 items always).

    python -m gnn_ecommerce_tpu_torch.runs.real_data_rehearsal [--rows 1000000] [--quick]
        [--raw-dir DIR] [--work DIR] [--device cuda] [--out x.json]
"""
from __future__ import annotations

import contextlib
import csv
import glob
import hashlib
import json
import math
import os
import shutil
import sys
import threading
import time
import urllib.request
import uuid

import numpy as np

from ..cli import eda as eda_cli
from ..cli import infer as infer_cli
from ..cli import preprocess as preprocess_cli
from ..cli import train as train_cli
from ..data.events import read_csv
from ..device import resolve_device
from ..serve import BatchingRecommender, RecommenderService
from ..serve.server import MODEL_NAME, make_server
from ..train.checkpoint import BEST_NAME
from . import _load, bars
from ._cli import emit, launches_since, quality_parser, work_dir

MONTHS = ["2019-Oct", "2019-Nov", "2019-Dec", "2020-Jan", "2020-Feb"]
MONTH_STARTS = ["2019-10-01", "2019-11-01", "2019-12-01", "2020-01-01", "2020-02-01"]
KAGGLE_COLUMNS = [
    "event_time", "event_type", "product_id", "category_id",
    "category_code", "brand", "price", "user_id", "user_session",
]
# The script's value pools, with the fields that force RFC-4180 quoting.
BRANDS = ["runail", "irisk", "masura", "grattol", "estel", "kapous", 'jas,"pro"', "co, ltd", ""]
CATEGORY_CODES = [
    "appliances.environment.vacuum", "furniture.bathroom.bath",
    "stationery.cartrige", 'accessories.bag,"hand"', "",
]
EVENT_TYPES = ["view", "cart", "remove_from_cart", "purchase"]
EVENT_TYPE_P = [0.75, 0.12, 0.06, 0.07]
MONTH_SECONDS = 28 * 24 * 3600
INT64_MAX = float(np.iinfo(np.int64).max)
ROWS = 1_000_000
# (dim, layers, epochs) of cli.train: the script's, and under --quick.
TRAIN = {False: (32, 3, 5), True: (16, 2, 2)}
MAX_PATH_USERS = 50
K = 20
EXTRA_KEYS = {"device", "launches", "bars"}


def zipf(rng: np.random.Generator, a: float, n: int) -> np.ndarray:
    """``n`` draws of numpy 2.0's ``Generator.zipf(a)`` from ``rng``, the
    same values and the same stream consumed, on any numpy: later numpy
    versions draw zipf another way (on numpy 2.3.5 the TPU file's 43,921
    users became 43,915). The rejection method of numpy's
    ``random_zipf``: each try takes two doubles ``U``, ``V``, proposes
    ``X = floor((1 - U)^(-1/(a-1)))`` and rejects an ``X`` beyond int64;
    ``math.pow`` is C's ``pow``, as there."""
    am1 = a - 1.0
    b, e = math.pow(2.0, am1), -1.0 / am1
    out = np.empty(n, np.int64)
    k = 0
    while k < n:
        state = rng.bit_generator.state
        tries = (n - k) + (n - k) // 2 + 64
        uv = rng.random(2 * tries).tolist()
        for j in range(tries):
            x = math.floor(math.pow(1.0 - uv[2 * j], e))
            if x > INT64_MAX or x < 1.0:
                continue
            t = math.pow(1.0 + 1.0 / x, am1)
            if uv[2 * j + 1] * x * (t - 1.0) / (b - 1.0) <= t / b:
                out[k] = int(x)
                k += 1
                if k == n:  # give back the doubles this call did not use
                    rng.bit_generator.state = state
                    rng.random(2 * (j + 1))
                    break
    return out


def fabricate(raw_dir: str, rows: int, seed: int = 42) -> dict:
    """Write the monthly CSVs; returns the rows of each month.

    The draws are the script's, in its order: both zipf pools (numpy 2.0's
    zipf, :func:`zipf`), then for each month the seconds, the event types,
    the category codes, the brands, the prices and the session indices
    (the order in which the script's DataFrame literal evaluates them)."""
    rng = np.random.default_rng(seed)
    os.makedirs(raw_dir, exist_ok=True)
    n_users, n_items = max(rows // 12, 50), max(rows // 400, 20)
    brands, cats = np.array(BRANDS, dtype=object), np.array(CATEGORY_CODES, dtype=object)
    etypes = np.array(EVENT_TYPES)
    per_month = np.full(len(MONTHS), rows // len(MONTHS))
    per_month[-1] += rows - per_month.sum()
    user_pool = zipf(rng, 1.3, rows * 2) % n_users
    item_pool = zipf(rng, 1.2, rows * 2) % n_items
    sessions = np.array([str(uuid.uuid4()) for _ in range(rows // 6 + 1)])
    written, lo = {}, 0
    for month, start, cnt in zip(MONTHS, MONTH_STARTS, per_month):
        cnt = int(cnt)
        t = np.datetime64(start, "s") + rng.integers(0, MONTH_SECONDS, cnt).astype("timedelta64[s]")
        event_type = etypes[rng.choice(4, cnt, p=EVENT_TYPE_P)]
        category_code = cats[rng.integers(0, len(cats), cnt)]
        brand = brands[rng.integers(0, len(brands), cnt)]
        price = np.round(rng.lognormal(1.2, 0.9, cnt), 2)
        session = sessions[rng.integers(0, len(sessions), cnt)]
        items = item_pool[lo : lo + cnt]
        columns = [
            np.char.add(np.char.replace(np.datetime_as_string(t, unit="s"), "T", " "), " UTC"),
            event_type,
            (5_000_000 + items).astype(str),
            (1_487_580_000_000_000_000 + items % 97).astype(str),
            category_code,
            brand,
            map(repr, price.tolist()),  # pandas writes a float64 as its repr
            (300_000_000 + user_pool[lo : lo + cnt]).astype(str),
            session,
        ]
        with open(os.path.join(raw_dir, f"{month}.csv"), "w", newline="") as f:
            writer = csv.writer(f, lineterminator="\n", quoting=csv.QUOTE_MINIMAL)
            writer.writerow(KAGGLE_COLUMNS)
            writer.writerows(zip(*(c.tolist() if isinstance(c, np.ndarray) else c for c in columns)))
        written[month] = cnt
        lo += cnt
    with open(os.path.join(raw_dir, f"{MONTHS[0]}.csv")) as f:
        header = f.readline().strip()
    assert header == ",".join(KAGGLE_COLUMNS), header
    return written


def rows_digest(raw_dir: str) -> str:
    """sha256 of the monthly files' lines, each without its last field (the
    session), in month order: what two fabrications of one seed share."""
    h = hashlib.sha256()
    for month in MONTHS:
        with open(os.path.join(raw_dir, f"{month}.csv"), "rb") as f:
            for line in f:
                h.update(line.rstrip(b"\n").rsplit(b",", 1)[0] + b"\n")
    return h.hexdigest()


def concat(files: list, out: str) -> tuple[int, bool]:
    """The files' rows under one header into ``out``, byte for byte. A file
    whose header is not ``KAGGLE_COLUMNS`` or with a row of another number
    of fields raises ``ValueError``. Returns (rows, whether a ``brand`` is
    ``co, ltd``)."""
    rows, co_ltd, brand = 0, False, KAGGLE_COLUMNS.index("brand")
    with open(out, "wb") as dst:
        dst.write((",".join(KAGGLE_COLUMNS) + "\n").encode())
        for path in files:
            with open(path, newline="") as f:
                reader = csv.reader(f)
                header = next(reader, None)
                if header != KAGGLE_COLUMNS:
                    raise ValueError(f"{path}: header {header}, not the Kaggle schema's {KAGGLE_COLUMNS}")
                for row in reader:
                    if not row:
                        continue
                    if len(row) != len(KAGGLE_COLUMNS):
                        raise ValueError(f"{path}:{reader.line_num}: {len(row)} fields, not 9")
                    rows += 1
                    co_ltd = co_ltd or row[brand] == "co, ltd"
            with open(path, "rb") as src:
                src.readline()
                body_at = src.tell()
                shutil.copyfileobj(src, dst)
                if src.tell() > body_at:  # a last row without its line break gets one
                    src.seek(-1, os.SEEK_END)
                    if src.read(1) != b"\n":
                        dst.write(b"\n")
    return rows, co_ltd


@contextlib.contextmanager
def in_dir(path: str):
    """``path`` as the working directory for the block, restored on every exit."""
    cwd = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(cwd)


def predict(port: int, user: int) -> list:
    """One POST of ``[user]`` to the predict route; its items."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/models/{MODEL_NAME}:predict",
        data=json.dumps([user]).encode(), headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=_load.CALL_TIMEOUT_S) as resp:
        items = json.loads(resp.read())["items"]
    assert len(items) == 1 and len(items[0]) == K, items
    return items[0]


def serve_round_trip(data_dir: str, ckpt_dir: str, dev) -> tuple[int, list]:
    """Stage 6: the best checkpoint's service behind the batcher and the
    HTTP server on an ephemeral port; one predict of the sampler's first
    user. Returns (user, items)."""
    svc = BatchingRecommender(RecommenderService.from_artifacts(data_dir, ckpt_dir, device=dev))
    server = make_server(svc, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        user = int(svc.prepared.sampler.users[0])
        return user, predict(server.server_address[1], user)
    finally:
        server.shutdown()
        server.server_close()
        thread.join()


def run(work: str, rows: int = ROWS, quick: bool = False, raw_dir: str | None = None,
        device="cuda") -> dict:
    """Stages 0-6 in ``work``; the script's keys plus ``device`` and the
    launches by stage. ``raw_dir`` skips stage 0 and reads its CSVs."""
    t_all = time.perf_counter()
    dev = resolve_device(device)
    os.makedirs(work, exist_ok=True)
    work = os.path.abspath(work)
    report, launches = {"rows_requested": rows}, {}

    @contextlib.contextmanager
    def stage(name: str):
        t0 = time.perf_counter()
        with launches_since() as counts, contextlib.redirect_stdout(sys.stderr):
            yield report.setdefault(name, {})
        launches[name] = counts
        report[name]["s"] = time.perf_counter() - t0
        _load.log(f"[{name}] {json.dumps(report[name])}")

    if raw_dir is None:
        raw_dir = os.path.join(work, "raw")
        with stage("fabricate") as r:
            r["per_month"] = fabricate(raw_dir, rows)

    with stage("concat") as r:
        files = sorted(glob.glob(os.path.join(raw_dir, "*.csv")))
        if not files:
            raise FileNotFoundError(f"no monthly CSVs under {raw_dir}")
        concat_path = os.path.join(work, "events_all.csv")
        n, co_ltd = concat(files, concat_path)
        if "fabricate" in report:
            assert n == rows, (n, rows)
            assert co_ltd, "no brand 'co, ltd' survived the round trip"
        r.update(rows=n, files=len(files))

    with stage("eda") as r:
        stats_path, report_path = os.path.join(work, "stats.json"), os.path.join(work, "profile.html")
        uie_path = os.path.join(work, "user_item_event.csv")
        eda_cli.main([
            "--events", concat_path, "--item-col", "product_id", "--stats", stats_path,
            "--report", report_path, "--out-events", uie_path,
        ])
        with open(stats_path) as f:
            stats = json.load(f)
        assert stats["n_events"] == report["concat"]["rows"], (stats["n_events"], report["concat"])
        assert os.path.getsize(report_path) > 10_000
        with open(report_path) as f:
            html = f.read()
        for sec in ("id='variables'", "id='missing'", "id='correlations'"):
            assert sec in html, sec
        r.update(n_users=stats["n_users"], n_items=stats["n_items"])

    with stage("preprocess") as r:
        edges_path = os.path.join(work, "u_i_weight.csv")
        preprocess_cli.main(["--events", uie_path, "-o", edges_path, "--scheme", "v1"])
        edges = read_csv(edges_path)
        assert {"user_id", "item_id", "weight"} <= set(edges)
        assert (edges["weight"] <= 1.0).all() and (edges["weight"] > 0).all()
        r["unique_edges"] = int(len(edges["weight"]))
        del edges

    with stage("train") as r:
        dim, layers, epochs = TRAIN[quick]
        with in_dir(work):
            train_cli.main([
                "--edges", edges_path, "-e", str(epochs), "--dim", str(dim), "--layers", str(layers),
                "--device", str(dev),
            ])
        ck = os.path.join(work, "model-checkpoints", BEST_NAME)
        assert os.path.exists(os.path.join(ck, "checkpoint.npz")), ck
        with open(os.path.join(ck, "meta.json")) as f:
            meta = json.load(f)
        r.update(best_epoch=meta["epoch"], val_recall=meta["recall"], dim=dim, layers=layers,
                 epochs=epochs)

    data_dir, ckpt_dir = os.path.join(work, "data", "prepared"), os.path.join(work, "model-checkpoints")
    with stage("infer"):
        out_dir = os.path.join(work, "recs")
        infer_cli.main([
            "-d", data_dir, "-c", ckpt_dir, "--out", out_dir,
            "--max-path-users", str(MAX_PATH_USERS), "--device", str(dev),
        ])
        assert os.path.exists(os.path.join(out_dir, f"metrics_K{K}.csv"))
        assert os.path.exists(os.path.join(out_dir, "hit_df.csv"))

    with stage("serve") as r:
        user, items = serve_round_trip(data_dir, ckpt_dir, dev)
        r.update(user=user, items=items[:5], n_items=len(items))

    report["total_s"] = time.perf_counter() - t_all
    return {**report, "device": _load.card(dev), "launches": launches}


def main(argv=None) -> int:
    ap = quality_parser(__doc__, work=True)
    ap.add_argument("--rows", type=int, default=ROWS)
    ap.add_argument("--raw-dir", help="existing directory of Kaggle monthly CSVs (skips fabrication: "
                    "the real-data path)")
    ap.add_argument("--quick", action="store_true", help="2 train epochs, dim 16, 2 layers")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    with work_dir(args.work) as work:
        line = run(work, args.rows, args.quick, args.raw_dir, dev)
    return emit(bars.hold(line, bars.BARS["real_data_rehearsal"](line)), args.out)


if __name__ == "__main__":
    sys.exit(main())
