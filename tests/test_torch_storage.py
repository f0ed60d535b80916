"""The port's conversation storage against the JAX package's, on the CPU.

The same operations, with values drawn from a numpy seed, run on both
packages' backends: memory, SQLite on a temporary file, Redis and Postgres
against the reference tests' in-process ``FakeRedis`` and ``FakePg``, and
Oracle against ``FakeOracle``.  Record ids come from one counter in both
packages (``storage.core._id`` is replaced for the test), and timestamps are
masked, so results compare row by row: every call's return value, the
SQLite tables, the RESP commands, and the SQL sent to Postgres and Oracle.
Then ``make_storage`` for every scheme, the SCRAM-SHA-256 vector of RFC 7677
and ``quote_literal``."""

import asyncio
import dataclasses
import itertools
import re
import sqlite3

import numpy as np
import pytest

from smg_tpu import storage as jst
from smg_tpu.storage import core as jcore
from smg_tpu.storage import oracle as joracle
from smg_tpu.storage import pgwire as jpg
from smg_tpu.storage import postgres as jpostgres
from smg_tpu.storage import redis as jredis
from smg_tpu.storage import resp as jresp
from smg_tpu_torch import storage as tst
from smg_tpu_torch.storage import core as tcore
from smg_tpu_torch.storage import oracle as toracle
from smg_tpu_torch.storage import pgwire as tpg
from smg_tpu_torch.storage import postgres as tpostgres
from smg_tpu_torch.storage import redis as tredis
from smg_tpu_torch.storage import resp as tresp
from smg_tpu_torch.storage import schema as tschema
from test_oracle_storage import FakeOracle
from test_storage_backends import FakePg, FakeRedis

PACKAGES = {
    "jax": dict(st=jst, core=jcore, oracle=joracle, pg=jpg, postgres=jpostgres,
                redis=jredis, resp=jresp),
    "port": dict(st=tst, core=tcore, oracle=toracle, pg=tpg, postgres=tpostgres,
                 redis=tredis, resp=tresp),
}
# a wall-clock timestamp as it appears in a row, a command or a statement
EPOCH = re.compile(r"1[6-9]\d{8}(\.\d+)?(e[+-]?\d+)?")
WORDS = ["hi", "y'all", "o''brien", "naïve", "x', (SELECT 1), 'y", "evil.NEXTVAL",
         "tab\tand\nnewline", "{\"json\": 1}", "", "plain"]


def _mask(obj):
    """Timestamps replaced by ``<t>``, in values and inside strings."""
    if isinstance(obj, float) and EPOCH.fullmatch(repr(obj)):
        return "<t>"
    if isinstance(obj, (bytes, bytearray)):
        obj = bytes(obj).decode(errors="replace")
    if isinstance(obj, str):
        return EPOCH.sub("<t>", obj)
    if isinstance(obj, dict):
        return {_mask(k): _mask(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_mask(v) for v in obj]
    return obj


def _plain(x):
    if dataclasses.is_dataclass(x):
        return {"kind": type(x).__name__, **dataclasses.asdict(x)}
    if isinstance(x, list):
        return [_plain(v) for v in x]
    return x


@pytest.fixture(autouse=True)
def same_ids(monkeypatch):
    """Both packages draw record ids from one sequence each, started alike."""
    for core in (jcore, tcore):
        counter = itertools.count()
        monkeypatch.setattr(core, "_id", lambda prefix, c=counter: f"{prefix}_{next(c):024d}")


def _script(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    pick = lambda: WORDS[int(rng.integers(len(WORDS)))]  # noqa: E731
    return dict(
        meta={pick(): pick(), "n": int(rng.integers(1000)), "f": float(rng.random())},
        update={"added": pick(), "n": int(rng.integers(1000))},
        items=[(str(rng.choice(["message", "function_call", "mcp_call", pick()])),
                [None, "user", "assistant", pick()][int(rng.integers(4))],
                {"content": pick(), "k": [pick(), int(rng.integers(9))]})
               for _ in range(int(rng.integers(3, 7)))],
        more=[("message", "user", {"content": pick()}) for _ in range(2)],
        output=[{"type": "message", "content": [{"type": "output_text", "text": pick()}]}],
        usage={"input_tokens": int(rng.integers(100)), "output_tokens": int(rng.integers(50))},
        drop=int(rng.integers(3)),
        chain=int(rng.integers(2, 5)),
    )


async def _drive(pkg: dict, s, seed: int) -> list:
    """The operations of ``_script(seed)`` on ``s``; every result, in order."""
    core, sc = pkg["core"], _script(seed)
    out = []
    rec = lambda name, v: out.append((name, _mask(_plain(v))))  # noqa: E731
    conv = await s.create_conversation(sc["meta"])
    rec("create", conv)
    rec("create_empty", await s.create_conversation())
    rec("get", await s.get_conversation(conv.id))
    rec("update", await s.update_conversation(conv.id, sc["update"]))
    rec("update_missing", await s.update_conversation("conv_missing", {"a": 1}))
    rec("get_updated", await s.get_conversation(conv.id))
    rec("list_conversations", sorted(c.id for c in await s.list_conversations()))
    items = [core.ConversationItem(type=t, role=r, content=c) for t, r, c in sc["items"]]
    rec("add", await s.add_items(conv.id, items))
    listed = await s.list_items(conv.id)
    rec("list", listed)
    rec("get_item", await s.get_item(conv.id, listed[sc["drop"]].id))
    rec("get_item_missing", await s.get_item(conv.id, "item_missing"))
    rec("delete_item", await s.delete_item(conv.id, listed[sc["drop"]].id))
    rec("delete_item_again", await s.delete_item(conv.id, listed[sc["drop"]].id))
    rec("add_more", await s.add_items(conv.id, [
        core.ConversationItem(type=t, role=r, content=c) for t, r, c in sc["more"]]))
    rec("list_after", await s.list_items(conv.id))
    prev = None
    for i in range(sc["chain"]):
        r = await s.store_response(core.StoredResponse(
            previous_response_id=prev, conversation_id=conv.id if i % 2 else None,
            model="m", output=sc["output"], input_items=[{"type": "message", "i": i}],
            usage=sc["usage"], metadata={"turn": i}))
        rec("store", r)
        prev = r.id
    rec("get_response", await s.get_response(prev))
    rec("chain", await s.response_chain(prev))
    rec("chain_short", await s.response_chain(prev, max_depth=1))
    first = (await s.response_chain(prev))[0].id
    rec("delete_response", await s.delete_response(first))
    rec("delete_response_again", await s.delete_response(first))
    rec("chain_cut", await s.response_chain(prev))
    rec("get_missing", await s.get_conversation("conv_missing"))
    rec("delete_conversation", await s.delete_conversation(conv.id))
    rec("delete_conversation_again", await s.delete_conversation(conv.id))
    rec("get_deleted", await s.get_conversation(conv.id))
    rec("list_deleted", await s.list_items(conv.id))
    return out


def _both(make, seed: int, check=None) -> list:
    """``_drive`` on each package's backend from ``make(pkg)`` = (storage,
    closer); the traces (and ``check(pkg)`` logs) must be equal."""
    traces, logs = {}, {}
    for name, pkg in PACKAGES.items():
        async def go():
            s, close = await make(pkg)
            try:
                traces[name] = await _drive(pkg, s, seed)
            finally:
                await close()
        asyncio.run(go())
        if check is not None:
            logs[name] = _mask(check(pkg))
    assert traces["port"] == traces["jax"]
    assert logs.get("port") == logs.get("jax")
    return traces["port"]


async def _noop():
    pass


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_memory_storage_matches_reference(seed):
    async def make(pkg):
        return pkg["st"].MemoryStorage(), _noop

    trace = _both(make, seed)
    assert dict(trace)["get_deleted"] is None


@pytest.mark.parametrize("seed", [0, 1])
def test_sqlite_storage_matches_reference_row_by_row(seed, tmp_path):
    paths = {}

    async def make(pkg):
        paths[pkg["st"].__name__] = path = tmp_path / f"{pkg['st'].__name__}.db"
        return pkg["st"].SqliteStorage(str(path)), _noop

    def rows(pkg):
        with sqlite3.connect(paths[pkg["st"].__name__]) as db:
            return {t: db.execute(f"SELECT * FROM {t} ORDER BY rowid").fetchall()
                    for t in ("conversations", "conversation_items", "responses")} | {
                "user_version": db.execute("PRAGMA user_version").fetchone()}

    _both(make, seed, check=rows)


def test_sqlite_storage_reopens_a_file_the_reference_wrote(tmp_path):
    """One file, the reference's migrations applied first: the port's
    backend opens it without migrating again and reads what it stored."""
    path = str(tmp_path / "shared.db")

    async def go():
        j = jst.SqliteStorage(path)
        conv = await j.create_conversation({"from": "jax"})
        await j.add_items(conv.id, [jcore.ConversationItem(role="user", content={"c": 1})])
        t = tst.SqliteStorage(path)
        got = await t.get_conversation(conv.id)
        items = await t.list_items(conv.id)
        return conv, got, items

    conv, got, items = asyncio.run(go())
    assert (got.id, got.metadata, got.created_at) == (conv.id, {"from": "jax"}, conv.created_at)
    assert [(i.role, i.content) for i in items] == [("user", {"c": 1})]


class LoggingRedis(FakeRedis):
    def __init__(self):
        super().__init__()
        self.log = []

    def dispatch(self, args):
        self.log.append([a.decode(errors="replace") for a in args])
        return super().dispatch(args)


@pytest.mark.parametrize("seed", [0, 1])
def test_redis_storage_matches_reference_commands(seed):
    fakes = {}

    async def make(pkg):
        fakes[pkg["st"].__name__] = fake = LoggingRedis()
        server = await asyncio.start_server(fake.serve, "127.0.0.1", 0)
        s = pkg["redis"].RedisStorage(client=pkg["resp"].RespClient(
            "127.0.0.1", server.sockets[0].getsockname()[1]))

        async def close():
            await s.close()
            server.close()
            await server.wait_closed()

        return s, close

    def state(pkg):
        fake = fakes[pkg["st"].__name__]
        return {"log": fake.log, "kv": fake.kv, "lists": fake.lists, "zsets": fake.zsets}

    _both(make, seed, check=state)


class LoggingPg(FakePg):
    def __init__(self):
        super().__init__()
        self.log = []

    def _query(self, sql, writer):
        self.log.append(sql)
        return super()._query(sql, writer)


@pytest.mark.parametrize("seed", [0, 1])
def test_postgres_storage_matches_reference_sql(seed):
    fakes = {}

    async def make(pkg):
        fakes[pkg["st"].__name__] = fake = LoggingPg()
        server = await asyncio.start_server(fake.serve, "127.0.0.1", 0)
        client = pkg["pg"].PgClient("127.0.0.1", server.sockets[0].getsockname()[1],
                                    user=FakePg.USER, password=FakePg.PASSWORD,
                                    database="smg")
        s = pkg["postgres"].PostgresStorage(client=client)

        async def close():
            await s.close()
            server.close()
            await server.wait_closed()

        return s, close

    _both(make, seed, check=lambda pkg: fakes[pkg["st"].__name__].log)


def test_pg_errors_match_reference():
    async def go(pkg):
        fake = FakePg()
        server = await asyncio.start_server(fake.serve, "127.0.0.1", 0)
        client = pkg["pg"].PgClient("127.0.0.1", server.sockets[0].getsockname()[1],
                                    user=FakePg.USER, password=FakePg.PASSWORD,
                                    database="smg")
        try:
            with pytest.raises(pkg["pg"].PgError) as e:
                await client.query("SELECT * FROM no_such_table")
            return type(e.value).__name__, str(e.value), await client.query("SELECT 1 AS one")
        finally:
            await client.close()
            server.close()
            await server.wait_closed()

    got = {n: asyncio.run(go(p)) for n, p in PACKAGES.items()}
    assert got["port"] == got["jax"]
    assert got["port"][2] == [{"one": "1"}]


REMAP = """{
  "conversations": {"table": "CHAT_SESSIONS",
                    "columns": {"id": "SESSION_ID", "created_at": "STARTED_AT"},
                    "extra_columns": {"REGION": "VARCHAR2(32)"},
                    "skip_columns": ["metadata"]},
  "conversation_items": {"table": "CHAT_TURNS", "columns": {"item_type": "KIND"}},
  "responses": {"columns": {"usage_json": "USAGE_DOC"}}
}"""


@pytest.mark.parametrize("seed,remap", [(0, False), (1, False), (2, True)],
                         ids=["default-0", "default-1", "remapped"])
def test_oracle_storage_matches_reference_sql_log(seed, remap):
    fakes = {}

    async def make(pkg):
        fakes[pkg["st"].__name__] = fake = FakeOracle()
        schema = (pkg["oracle"].SchemaConfig.from_json(REMAP) if remap else None)
        return pkg["oracle"].OracleStorage(fake, schema=schema), _noop

    _both(make, seed, check=lambda pkg: fakes[pkg["st"].__name__].sql_log)


def test_schema_config_matches_reference():
    from smg_tpu.storage import schema as jschema

    for text in (REMAP, "{}", '{"responses": {"skip_columns": ["metadata", "usage_json"]}}'):
        j, t = jschema.SchemaConfig.from_json(text), tschema.SchemaConfig.from_json(text)
        for logical, cols in joracle.LOGICAL_TABLES.items():
            assert (t.table(logical).name, t.table(logical).live_columns(cols)) == \
                   (j.table(logical).name, j.table(logical).live_columns(cols))


def _result(fn, *args):
    """("ok", the return value) or (the exception's type, its text)."""
    try:
        return ("ok", fn(*args))
    except Exception as e:  # the error is the outcome compared
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("spec", [
    None, "", "memory", "sqlite:", "redis://h:1/2", "rediss://:pw@h:6380/1",
    "postgres://u:p@h/db", "postgresql://u@h:5433/x", "oracle://user:pw@dbhost:1521/XEPDB1",
    "bogus://x", "nosuch://x", "sqlite",
])
def test_make_storage_matches_reference(spec):
    want = _result(lambda s: type(jst.make_storage(s)).__name__, spec)
    assert _result(lambda s: type(tst.make_storage(s)).__name__, spec) == want
    if spec in ("bogus://x", "nosuch://x"):
        assert want == ("ValueError", f"unknown storage spec {spec!r}")
    if spec and spec.startswith("oracle://"):
        assert want[0] == "RuntimeError" and "oracledb" in want[1]


SERVER_FIRST = (b"r=rOprNGfwEbeRWgbNEkqO%hvYDpWUa2RaTCAfuxFIlj)hNlF$k0,"
                b"s=W22ZaJ0SNY7soEsUEjb6gQ==,i=4096")


@pytest.mark.parametrize("pg", [jpg, tpg], ids=["jax", "port"])
def test_scram_sha256_rfc7677_vector(pg):
    c = pg.ScramClient("user", "pencil", nonce="rOprNGfwEbeRWgbNEkqO")
    assert c.first_message() == b"n,,n=user,r=rOprNGfwEbeRWgbNEkqO"
    assert c.final_message(SERVER_FIRST) == (
        b"c=biws,r=rOprNGfwEbeRWgbNEkqO%hvYDpWUa2RaTCAfuxFIlj)hNlF$k0,"
        b"p=dHzbZapWIk4jUhN+Ute9ytag9zjfMHgsqmmiz7AndVQ=")
    c.verify_server(b"v=6rriTRBi23WpRR/wtup+mMhUZUn/dB5nLTJRsjl95G4=")


def test_scram_wrong_server_signature_matches_reference():
    got = []
    for pg in (jpg, tpg):
        c = pg.ScramClient("user", "pencil", nonce="rOprNGfwEbeRWgbNEkqO")
        c.first_message()
        c.final_message(SERVER_FIRST)
        got.append(_result(c.verify_server, b"v=AAAA"))
    assert got[1] == got[0] and got[0][0] != "ok"


def test_quote_literal_matches_reference():
    rng = np.random.default_rng(0)
    values = [None, True, False, 0, -7, 5, 2.5, float(rng.random()), "o'brien", "",
              "a\x00b", "''", "\\", *WORDS,
              *("".join(chr(int(c)) for c in rng.integers(32, 0x2FF, 12)) for _ in range(20))]
    for v in values:
        assert _result(tpg.quote_literal, v) == _result(jpg.quote_literal, v), v
    assert tpg.quote_literal("o'brien") == "'o''brien'"
    assert _result(tpg.quote_literal, "a\x00b")[0] == "ValueError"
