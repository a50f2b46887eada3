"""The port's access plane (``emqx_tpu_torch.banned``,
``emqx_tpu_torch.flapping``, the file ACL's deny action and the
channel's CONNECT and disconnect seams) against the JAX package's.

Each case of ``tests/test_modules.py``'s ban and flapping tests, of
``tests/test_flapping.py`` and of ``tests/test_acl_deny_action.py``
(there with ``AclFileModule`` loaded on a node of each package, in
place of a bare hook) runs the same operations on the JAX objects and
on the port's, keeps the original test's assertions, and the two
observations must be equal: verdicts, rules, tracks, and the packets
a channel answers, serialized with the client's protocol version.
"""

import time

import pytest

from emqx_tpu.banned import Banned as JBanned
from emqx_tpu.channel import Channel as JChannel
from emqx_tpu.flapping import Flapping as JFlapping
from emqx_tpu.flapping import FlappingConfig as JFlappingConfig
from emqx_tpu.flapping import SERVER_INITIATED as J_SERVER_INITIATED
from emqx_tpu.modules.acl_file import AclFileModule as JAcl
from emqx_tpu.mqtt import frame as JF
from emqx_tpu.mqtt import packet as JP
from emqx_tpu.mqtt import reason_codes as RC
from emqx_tpu.node import Node as JNode
from emqx_tpu.zone import Zone as JZone
from emqx_tpu_torch.banned import Banned as PBanned
from emqx_tpu_torch.channel import Channel as PChannel
from emqx_tpu_torch.flapping import Flapping as PFlapping
from emqx_tpu_torch.flapping import FlappingConfig as PFlappingConfig
from emqx_tpu_torch.flapping import SERVER_INITIATED as P_SERVER_INITIATED
from emqx_tpu_torch.modules.acl_file import AclFileModule as PAcl
from emqx_tpu_torch.mqtt import frame as PF
from emqx_tpu_torch.node import Node as PNode
from emqx_tpu_torch.zone import Zone as PZone
from test_torch_channel import _wire, to_port

C = JP.C


class _Pkg:
    def __init__(self, **kw) -> None:
        self.__dict__.update(kw)


JAX = _Pkg(name="jax", Banned=JBanned, Flapping=JFlapping,
           FlappingConfig=JFlappingConfig, Acl=JAcl, Channel=JChannel,
           Zone=JZone, serialize=JF.serialize, port=False,
           Node=lambda **kw: JNode(boot_listeners=False, **kw))
PORT = _Pkg(name="port", Banned=PBanned, Flapping=PFlapping,
            FlappingConfig=PFlappingConfig, Acl=PAcl, Channel=PChannel,
            Zone=PZone, serialize=PF.serialize, port=True,
            Node=lambda **kw: PNode(device="cpu", **kw))


def both(scenario, *args):
    """``scenario(pkg, *args)`` on the JAX package, then on the port:
    the two observations must be equal."""
    want = scenario(JAX, *args)
    got = scenario(PORT, *args)
    assert got == want
    return got


def _rule(r):
    """A ban rule's comparable fields: the two runs are moments apart,
    so of ``at`` and ``until`` only whether the ban is permanent."""
    if r is None:
        return None
    return (r.who, r.by, r.reason, r.until is None)


def _mk(P, max_count=5, window=60.0, ban_time=300.0, banned=None):
    return P.Flapping(
        banned=banned if banned is not None else P.Banned(),
        config=P.FlappingConfig(max_count=max_count, window=window,
                                ban_time=ban_time))


def test_server_initiated_reasons_equal():
    assert P_SERVER_INITIATED == J_SERVER_INITIATED == \
        frozenset({"drained", "server_shutdown"})


# -- tests/test_modules.py: banned / flapping --------------------------------

def _banned_check_and_expiry(P):
    b = P.Banned()
    b.create("clientid", "evil")
    b.create("peerhost", "10.0.0.1", duration=0.0)
    out = [b.check(clientid="evil"), b.check(clientid="good")]
    time.sleep(0.01)
    out.append(b.check(peerhost="10.0.0.1"))  # expired lazily
    out.append(b.look_up("peerhost", "10.0.0.1"))
    b.delete("clientid", "evil")
    out.append(b.check(clientid="evil"))
    assert out == [True, False, False, None, False]
    with pytest.raises(ValueError):
        b.create("bogus", "v")
    return out


def test_banned_check_and_expiry():
    both(_banned_check_and_expiry)


def _banned_facets_and_expire(P):
    b = P.Banned()
    b.create("username", "mallory", by="op", reason="r")
    b.create("peerhost", "10.9.9.9", duration=60)
    b.create("clientid", "short", duration=0.0)
    out = [b.check(clientid="x", username="mallory"),
           b.check(clientid="x", username=None, peerhost="10.9.9.9"),
           b.check(clientid="x", username=None, peerhost="10.9.9.8")]
    time.sleep(0.01)
    out.append(b.expire())
    out.append(sorted(_rule(r) for r in b.info()))
    out.append(b.expire(now=time.time() + 120))
    out.append([_rule(r) for r in b.info()])
    return out


def test_banned_every_facet_and_the_expiry_sweep():
    both(_banned_facets_and_expire)


def _flapping_threshold(P):
    b = P.Banned()
    f = P.Flapping(banned=b, config=P.FlappingConfig(
        max_count=3, window=10, ban_time=100))
    for _ in range(3):
        f.disconnected("flappy", "1.2.3.4")
    assert b.check(clientid="flappy")
    return _rule(b.look_up("clientid", "flappy"))


def test_flapping_bans_after_threshold():
    both(_flapping_threshold)


# -- tests/test_flapping.py ---------------------------------------------------

def _threshold_bans_client(P):
    fl = _mk(P, max_count=3)
    for _ in range(2):
        fl.disconnected("c1")
    assert fl.banned.look_up("clientid", "c1") is None
    fl.disconnected("c1")  # third strike inside the window
    rule = fl.banned.look_up("clientid", "c1")
    assert rule is not None
    assert rule.by == "flapping"
    assert "c1" not in fl._tracks
    return _rule(rule)


def _below_threshold_never_bans(P):
    fl = _mk(P, max_count=10)
    for _ in range(9):
        fl.disconnected("quiet")
    assert fl.banned.look_up("clientid", "quiet") is None
    return fl._tracks["quiet"].count


def _window_expiry_resets_count(P):
    fl = _mk(P, max_count=3, window=60.0)
    fl.disconnected("c2")
    fl.disconnected("c2")
    fl._tracks["c2"].started -= 61.0
    fl.disconnected("c2")
    assert fl.banned.look_up("clientid", "c2") is None
    assert fl._tracks["c2"].count == 1
    return fl._tracks["c2"].count


def _gc_drops_stale_tracks_only(P):
    fl = _mk(P, max_count=10, window=60.0)
    fl.disconnected("old")
    fl.disconnected("fresh")
    fl._tracks["old"].started -= 120.0
    fl.gc()
    assert "old" not in fl._tracks
    assert "fresh" in fl._tracks
    return sorted(fl._tracks)


def _never_downgrades_operator_ban(P):
    banned = P.Banned()
    banned.create("clientid", "vip-blocked", by="admin",
                  reason="operator rule", duration=None)  # permanent
    fl = _mk(P, max_count=2, ban_time=10.0, banned=banned)
    fl.disconnected("vip-blocked")
    fl.disconnected("vip-blocked")
    rule = banned.look_up("clientid", "vip-blocked")
    assert rule.by == "admin"
    assert rule.until is None
    return _rule(rule)


def _reconnect_storm(P):
    fl = _mk(P, max_count=15, window=60.0, ban_time=300.0)
    flappers = [f"flap-{i}" for i in range(20)]
    steady = [f"steady-{i}" for i in range(200)]
    for cid in steady:
        fl.disconnected(cid)
        fl.disconnected(cid)
    for _ in range(15):
        for cid in flappers:
            fl.disconnected(cid)
    for cid in flappers:
        rule = fl.banned.look_up("clientid", cid)
        assert rule is not None and rule.by == "flapping", cid
        assert fl.banned.check(clientid=cid), cid
    for cid in steady:
        assert fl.banned.look_up("clientid", cid) is None, cid
    fl.gc(now=time.time() + 61.0)
    assert not fl._tracks
    return sorted(_rule(r) for r in fl.banned.info())


def _rejected_then_expires(P):
    fl = _mk(P, max_count=2, ban_time=0.3)
    fl.disconnected("bounce")
    fl.disconnected("bounce")
    first = fl.banned.check(clientid="bounce")
    assert first
    time.sleep(0.35)
    later = fl.banned.check(clientid="bounce")
    assert not later
    return first, later


@pytest.mark.parametrize("scenario", [
    _threshold_bans_client, _below_threshold_never_bans,
    _window_expiry_resets_count, _gc_drops_stale_tracks_only,
    _never_downgrades_operator_ban, _reconnect_storm,
    _rejected_then_expires], ids=lambda f: f.__name__.strip("_"))
def test_flapping_cases(scenario):
    both(scenario)


# -- the channel's seams: the CONNECT ban check, the disconnect count ---------

def _connect(ver, cid, username=None):
    return JP.Connect(proto_ver=ver, proto_name=C.PROTOCOL_NAMES[ver],
                      client_id=cid, clean_start=True, username=username)


def _chan(P, node, zone, peer="10.0.0.7"):
    ch = P.Channel(node.broker, node.cm, zone=zone, peername=(peer, 4242))
    ch.on_deliver = lambda: None
    return ch


def _step(P, ch, pkt):
    if P.port:
        pkt = to_port(pkt)
    return _wire(ch.handle_in(pkt), ch.proto_ver, P.serialize)


def _connect_banned(P, ver):
    node = P.Node()
    zone = P.Zone(name="access")
    node.banned.create("clientid", "evil")
    node.banned.create("username", "mallory")
    node.banned.create("peerhost", "10.6.6.6")
    out = {}
    for key, cid, user, peer in (("clientid", "evil", None, "10.0.0.7"),
                                 ("username", "c2", "mallory", "10.0.0.7"),
                                 ("peerhost", "c3", None, "10.6.6.6"),
                                 ("free", "c4", None, "10.0.0.7")):
        ch = _chan(P, node, zone, peer)
        out[key] = (_step(P, ch, _connect(ver, cid, user)),
                    ch.closed, ch.close_after_send, ch.disconnect_reason)
    out["metrics"] = [node.metrics.val(k) for k in (
        "packets.connack.error", "client.connack", "client.connected")]
    # the zone's enable_ban off lets the banned client in
    ch = _chan(P, node, P.Zone(name="noban", enable_ban=False))
    out["noban"] = _step(P, ch, _connect(ver, "evil"))
    return out


@pytest.mark.parametrize("ver", [3, 4, 5])
def test_banned_client_gets_connack_banned(ver):
    out = both(_connect_banned, ver)
    # v5: 0x8A Banned; v3/v4 map it to 5 (not authorized)
    for key in ("clientid", "username", "peerhost"):
        connack = JF.Parser(version=ver).feed(out[key][0][0])[0]
        assert connack.reason_code == (RC.BANNED if ver == 5 else 5), key
        assert out[key][1:3] == (True, True)
    assert out["free"][0] != out["clientid"][0]


def _flapping_channel(P, reason):
    """Disconnects through the channel, counted by the node's flapping
    detector with their reason (max_count 2): a client-side close
    counts, a server-initiated one does not."""
    node = P.Node()
    node.flapping.config = P.FlappingConfig(max_count=2, window=60.0)
    zone = P.Zone(name="flap", enable_flapping_detect=True)
    for i in range(2):
        ch = _chan(P, node, zone)
        _step(P, ch, _connect(4, "flapc"))
        if reason == "client":
            _step(P, ch, JP.Disconnect())
        else:
            ch.disconnect_reason = reason
            ch._shutdown()
    banned = node.banned.look_up("clientid", "flapc")
    ch = _chan(P, node, zone)
    again = _step(P, ch, _connect(4, "flapc"))
    off = _chan(P, node, P.Zone(name="noflap"))  # detection off
    _step(P, off, _connect(4, "other"))
    _step(P, off, JP.Disconnect())
    return (_rule(banned), again, sorted(node.flapping._tracks),
            ch.disconnect_reason)


@pytest.mark.parametrize("reason", ["client", "drained", "server_shutdown",
                                    "keepalive_timeout"])
def test_flapping_counts_disconnects_by_reason(reason):
    banned, again, tracks, _ = both(_flapping_channel, reason)
    assert (banned is not None) == (reason not in J_SERVER_INITIATED)
    if banned is not None:
        assert banned[1] == "flapping"
        # v4: the banned CONNACK maps to 5, not authorized
        assert JF.Parser(version=4).feed(again[0])[0].reason_code == 5


# -- tests/test_acl_deny_action.py, with AclFileModule loaded ----------------

def _acl_chan(P, action):
    node = P.Node()
    node.modules.load(P.Acl, {"rules": [
        ("deny", "all", "pubsub", ["secret/#"]),
        ("allow", "all", "pubsub", ["#"]),
    ]})
    zone = P.Zone(name=f"acl-{action}", acl_deny_action=action)
    ch = _chan(P, node, zone)
    out = _step(P, ch, JP.Connect(proto_ver=C.MQTT_V5, proto_name="MQTT",
                                  client_id="aclc", clean_start=True))
    assert JF.Parser(version=5).feed(out[0])[0].reason_code == 0
    return ch


def _publish_deny(P, action):
    ch = _acl_chan(P, action)
    out = _step(P, ch, JP.Publish(topic="secret/t", qos=1, packet_id=1))
    ok = _step(P, ch, JP.Publish(topic="open/t", qos=1, packet_id=2)) \
        if not ch.closed else None
    return out, ok, ch.closed, ch.close_after_send


def _subscribe_deny(P, action, order):
    ch = _acl_chan(P, action)
    flts = [("secret/t", {"qos": 1, "nl": 0, "rap": 0, "rh": 0}),
            ("open/t", {"qos": 1, "nl": 0, "rap": 0, "rh": 0})]
    if order == "open-first":
        flts.reverse()
    out = _step(P, ch, JP.Subscribe(packet_id=1, topic_filters=flts))
    return out, ch.closed, ch.close_after_send


def test_publish_deny_ignore_acks_not_authorized():
    out, ok, closed, after = both(_publish_deny, "ignore")
    puback = JF.Parser(version=5).feed(out[0])[0]
    assert isinstance(puback, JP.PubAck)
    assert puback.reason_code == RC.NOT_AUTHORIZED
    assert not closed and ok is not None


def test_publish_deny_disconnect_drops_client():
    out, _ok, _closed, after = both(_publish_deny, "disconnect")
    pkts = [p for o in out for p in JF.Parser(version=5).feed(o)]
    assert any(isinstance(p, JP.Disconnect) and
               p.reason_code == RC.NOT_AUTHORIZED for p in pkts), pkts
    assert after


def test_subscribe_deny_ignore_suback_rc():
    out, closed, _after = both(_subscribe_deny, "ignore", "secret-first")
    suback = JF.Parser(version=5).feed(out[0])[0]
    assert isinstance(suback, JP.Suback)
    assert suback.reason_codes[0] == RC.NOT_AUTHORIZED
    assert suback.reason_codes[1] in (0, 1)
    assert not closed


def test_subscribe_deny_disconnect_on_any_denied_filter():
    out, _closed, after = both(_subscribe_deny, "disconnect", "open-first")
    pkts = [p for o in out for p in JF.Parser(version=5).feed(o)]
    assert any(isinstance(p, JP.Disconnect) and
               p.reason_code == RC.NOT_AUTHORIZED for p in pkts), pkts
    assert after


# -- the default rules over a channel: $SYS/# for non-local clients ----------

def _default_rules_sys(P, peer, user):
    node = P.Node()
    node.modules.load(P.Acl)  # DEFAULT_RULES
    ch = _chan(P, node, P.Zone(name="acl-default"), peer)
    _step(P, ch, _connect(5, "sysc", user))
    return _step(P, ch, JP.Subscribe(packet_id=1, topic_filters=[
        ("$SYS/#", {"qos": 0, "nl": 0, "rap": 0, "rh": 0}),
        ("#", {"qos": 0, "nl": 0, "rap": 0, "rh": 0}),
        ("a/+", {"qos": 1, "nl": 0, "rap": 0, "rh": 0})]))


@pytest.mark.parametrize("peer,user,want", [
    ("10.0.0.7", None, [RC.NOT_AUTHORIZED, RC.NOT_AUTHORIZED, 1]),
    ("127.0.0.1", None, [0, 0, 1]),
    ("10.0.0.7", "dashboard", [0, RC.NOT_AUTHORIZED, 1])])
def test_default_rules_deny_sys_to_non_local_clients(peer, user, want):
    out = both(_default_rules_sys, peer, user)
    suback = JF.Parser(version=5).feed(out[0])[0]
    assert list(suback.reason_codes) == want
