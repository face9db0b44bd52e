"""The port's request classification against the JAX package's: classes,
thread-local scopes, header propagation, the tenant class map and the
Retry-After jitter, on the same inputs."""

import threading

import pytest

from seaweedfs_tpu.qos import classify as j_cls
from seaweedfs_tpu_torch import qos as t_qos
from seaweedfs_tpu_torch.qos import classify as t_cls

BOTH = pytest.mark.parametrize("cls", [j_cls, t_cls], ids=["jax", "port"])


def test_constants_equal_jax():
    for name in ("INTERACTIVE", "STANDARD", "BACKGROUND", "CLASSES",
                 "QOS_HEADER", "TENANT_HEADER"):
        assert getattr(j_cls, name) == getattr(t_cls, name)
    for name in ("qos_scope", "current_class", "enabled", "LANES",
                 "DeviceLanes", "lanes_enabled", "inject", "from_headers"):
        assert hasattr(t_qos, name)


@pytest.mark.parametrize("raw", [None, "", "interactive", "standard",
                                 "background", "BACKGROUND", "bogus"])
def test_normalize_equal_jax(raw):
    assert j_cls.normalize(raw) == t_cls.normalize(raw)


@pytest.mark.parametrize("headers", [
    {}, {"X-QoS-Class": "background"},
    {"X-QoS-Class": "interactive", "X-QoS-Tenant": "app"},
    {"X-QoS-Class": "nope", "X-QoS-Tenant": ""}])
def test_from_headers_equal_jax(headers):
    assert j_cls.from_headers(headers) == t_cls.from_headers(headers)


@BOTH
def test_scopes_nest_and_restore(cls):
    assert cls.current_class() == cls.STANDARD
    assert cls.current_tenant() == ""
    with cls.qos_scope("background", tenant="maintenance"):
        assert cls.current_class() == cls.BACKGROUND
        assert cls.inject({}) == {cls.QOS_HEADER: "background",
                                  cls.TENANT_HEADER: "maintenance"}
        with cls.qos_scope("interactive"):
            assert cls.current_class() == cls.INTERACTIVE
            assert cls.current_tenant() == "maintenance"
        with cls.qos_scope("weird", tenant=""):
            assert cls.current_class() == cls.STANDARD
            assert cls.inject({}) == {cls.QOS_HEADER: "standard"}
        assert cls.current_class() == cls.BACKGROUND
    assert cls.current_class() == cls.STANDARD
    assert cls.inject({}) == {}


@BOTH
def test_scope_is_thread_local(cls):
    seen = []
    with cls.qos_scope("background"):
        t = threading.Thread(target=lambda: seen.append(cls.current_class()))
        t.start()
        t.join()
    assert seen == [cls.STANDARD]


@BOTH
def test_set_qos_returns_previous_pair(cls):
    prev = cls.set_qos("interactive", "t1")
    try:
        assert (cls.current_class(), cls.current_tenant()) == \
            ("interactive", "t1")
        assert cls.set_qos("background") == ("interactive", "t1")
    finally:
        cls.set_qos(*prev)
    assert cls.current_class() == cls.STANDARD


@pytest.mark.parametrize("spec,tenant", [
    ("", "app"), ("analytics=background,mobile=interactive", "analytics"),
    ("analytics=background, mobile = interactive", "mobile"),
    ("analytics=bogus", "analytics"), ("a=background", "")])
def test_class_for_tenant_equal_jax(monkeypatch, spec, tenant):
    monkeypatch.setenv("WEED_QOS_CLASS_MAP", spec)
    assert j_cls.class_for_tenant(tenant, "standard") == \
        t_cls.class_for_tenant(tenant, "standard")


@pytest.mark.parametrize("base,spread", [(1, 3), (0, 0), (5, 1), (2, -4)])
def test_retry_after_equal_jax(base, spread):
    draws = [0.0, 0.24, 0.5, 0.99]
    for r in draws:
        assert j_cls.retry_after(base, spread, rand=lambda: r) == \
            t_cls.retry_after(base, spread, rand=lambda: r)


@pytest.mark.parametrize("value", ["0", "1", ""])
def test_master_switch_gates_lanes(monkeypatch, value):
    """WEED_QOS=0 turns classification and with it the device lanes off,
    as in the JAX package."""
    from seaweedfs_tpu.qos import lanes as j_lanes

    if value:
        monkeypatch.setenv("WEED_QOS", value)
    else:
        monkeypatch.delenv("WEED_QOS", raising=False)
    assert j_cls.enabled() == t_cls.enabled() == (value != "0")
    assert j_lanes.lanes_enabled() == t_qos.lanes_enabled()
