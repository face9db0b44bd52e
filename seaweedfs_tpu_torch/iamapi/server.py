"""AWS IAM-compatible management API.

Parity with weed/iamapi/iamapi_server.go + iamapi_management_handlers.go:
form-encoded Action= requests (CreateUser, ListUsers, GetUser, DeleteUser,
CreateAccessKey, DeleteAccessKey, PutUserPolicy, GetUserPolicy,
DeleteUserPolicy) that mutate the same identity config the S3 gateway
authenticates against; the config persists in the filer at
/etc/iam/identity.json (the reference stores s3 config through the filer
the same way, iamapi_server.go GetS3ApiConfiguration/PutS3ApiConfiguration).
Policy statements map onto the gateway's action list the way the
reference's GetActions does (Get/Put/List/Tagging/Admin on arn buckets).

The port's own copy of seaweedfs_tpu/iamapi/server.py.
"""

from __future__ import annotations

import json
import secrets
import time
import urllib.parse
import uuid
import xml.etree.ElementTree as ET
from typing import Optional

from ..filer.entry import Attr, Entry
from ..filer.filer import Filer
from ..filer.filer_store import NotFoundError
from ..rpc.http_rpc import Request, Response, RpcError, RpcServer
from ..s3api.auth import (ACTION_ADMIN, ACTION_LIST, ACTION_READ,
                          ACTION_WRITE, Identity)

IDENTITY_CONFIG_PATH = "/etc/iam/identity.json"


def _policy_to_actions(policy_doc: dict) -> list[str]:
    """Map an IAM policy document onto gateway actions
    (iamapi_management_handlers.go GetActions)."""
    actions: list[str] = []
    for statement in policy_doc.get("Statement", []):
        if statement.get("Effect") != "Allow":
            continue
        stmt_actions = statement.get("Action", [])
        if isinstance(stmt_actions, str):
            stmt_actions = [stmt_actions]
        resources = statement.get("Resource", [])
        if isinstance(resources, str):
            resources = [resources]
        buckets = []
        for res in resources:
            # arn:aws:s3:::bucket/* or arn:aws:s3:::*
            tail = res.split(":::", 1)[-1]
            bucket = tail.split("/", 1)[0]
            buckets.append("" if bucket in ("*", "") else bucket)
        for act in stmt_actions:
            verb = act.split(":", 1)[-1]
            for bucket in buckets or [""]:
                suffix = f":{bucket}" if bucket else ""
                if verb == "*":
                    actions.append(ACTION_ADMIN + suffix)
                elif verb in ("GetObject", "GetObjectAcl"):
                    actions.append(ACTION_READ + suffix)
                elif verb in ("PutObject", "PutObjectAcl", "DeleteObject"):
                    actions.append(ACTION_WRITE + suffix)
                elif verb in ("ListBucket", "ListAllMyBuckets"):
                    actions.append(ACTION_LIST + suffix)
    return sorted(set(actions))


class IamIdentityStore:
    """Identity config shared with the S3 gateway, persisted in the filer."""

    def __init__(self, filer: Filer):
        self.filer = filer

    def load(self) -> dict:
        try:
            entry = self.filer.find_entry(IDENTITY_CONFIG_PATH)
            return json.loads(entry.content.decode())
        except (NotFoundError, ValueError):
            return {"identities": []}

    def save(self, config: dict):
        body = json.dumps(config, indent=2).encode()
        self.filer.create_entry(Entry(
            full_path=IDENTITY_CONFIG_PATH,
            attr=Attr(mtime=time.time(), crtime=time.time(),
                      file_size=len(body)),
            content=body))

    def identities(self) -> list[Identity]:
        return [Identity(name=i["name"],
                         access_key=i.get("access_key", ""),
                         secret_key=i.get("secret_key", ""),
                         actions=i.get("actions", []))
                for i in self.load().get("identities", [])]


class IamApiServer:
    def __init__(self, filer_server, host: str = "127.0.0.1", port: int = 0,
                 s3_server=None):
        self.filer = filer_server.filer
        self.store = IamIdentityStore(self.filer)
        self.s3_server = s3_server  # live-reload its IAM on changes
        self.server = RpcServer(host, port)
        self.server.default_route = self._handle
        # persisted identities take effect immediately on startup, not only
        # after the next IAM mutation
        config = self.store.load()
        if config.get("identities"):
            self._sync_s3(config)

    @property
    def address(self) -> str:
        return self.server.address

    def start(self):
        self.server.start()

    def stop(self):
        self.server.stop()

    def _sync_s3(self, config: dict):
        if self.s3_server is not None:
            from ..s3api.auth import IdentityAccessManagement

            self.s3_server.iam = IdentityAccessManagement([
                Identity(name=i["name"],
                         access_key=i.get("access_key", ""),
                         secret_key=i.get("secret_key", ""),
                         actions=i.get("actions", []))
                for i in config.get("identities", [])])

    # -- request handling ----------------------------------------------------
    def _handle(self, method: str, req: Request):
        if method != "POST":
            raise RpcError("IAM requires POST", 405)
        form = urllib.parse.parse_qs(req.body.decode("utf-8", "replace"))
        params = {k: v[0] for k, v in form.items()}
        params.update({k: str(v) for k, v in req.query.items()})
        action = params.get("Action", "")
        handler = getattr(self, f"_do_{action}", None)
        if handler is None:
            return self._error("InvalidAction", f"unknown action {action}",
                               400)
        return handler(params)

    @staticmethod
    def _error(code: str, message: str, status: int) -> Response:
        root = ET.Element("ErrorResponse")
        err = ET.SubElement(root, "Error")
        ET.SubElement(err, "Code").text = code
        ET.SubElement(err, "Message").text = message
        return Response(ET.tostring(root), status, "application/xml")

    @staticmethod
    def _ok(action: str, payload: Optional[dict] = None) -> Response:
        root = ET.Element(f"{action}Response",
                          xmlns="https://iam.amazonaws.com/doc/2010-05-08/")
        result = ET.SubElement(root, f"{action}Result")

        def build(parent, value):
            if isinstance(value, dict):
                for k, v in value.items():
                    if isinstance(v, list):
                        wrap = ET.SubElement(parent, k)
                        for item in v:
                            member = ET.SubElement(wrap, "member")
                            build(member, item)
                    else:
                        node = ET.SubElement(parent, k)
                        build(node, v)
            else:
                parent.text = "" if value is None else str(value)

        if payload:
            build(result, payload)
        meta = ET.SubElement(root, "ResponseMetadata")
        ET.SubElement(meta, "RequestId").text = uuid.uuid4().hex
        return Response(
            b'<?xml version="1.0" encoding="UTF-8"?>' + ET.tostring(root),
            200, "application/xml")

    def _find_user(self, config: dict, name: str) -> Optional[dict]:
        for ident in config.get("identities", []):
            if ident["name"] == name:
                return ident
        return None

    # -- user CRUD -----------------------------------------------------------
    def _do_CreateUser(self, params: dict):
        name = params.get("UserName", "")
        if not name:
            return self._error("InvalidInput", "missing UserName", 400)
        config = self.store.load()
        if self._find_user(config, name):
            return self._error("EntityAlreadyExists", name, 409)
        config.setdefault("identities", []).append(
            {"name": name, "access_key": "", "secret_key": "",
             "actions": []})
        self.store.save(config)
        self._sync_s3(config)
        return self._ok("CreateUser", {"User": {
            "UserName": name, "UserId": name,
            "Arn": f"arn:aws:iam:::user/{name}"}})

    def _do_ListUsers(self, params: dict):
        config = self.store.load()
        return self._ok("ListUsers", {"Users": [
            {"UserName": i["name"], "UserId": i["name"],
             "Arn": f"arn:aws:iam:::user/{i['name']}"}
            for i in config.get("identities", [])
        ], "IsTruncated": "false"})

    def _do_GetUser(self, params: dict):
        name = params.get("UserName", "")
        user = self._find_user(self.store.load(), name)
        if user is None:
            return self._error("NoSuchEntity", name, 404)
        return self._ok("GetUser", {"User": {
            "UserName": name, "UserId": name,
            "Arn": f"arn:aws:iam:::user/{name}"}})

    def _do_UpdateUser(self, params: dict):
        name = params.get("UserName", "")
        new_name = params.get("NewUserName", "")
        config = self.store.load()
        user = self._find_user(config, name)
        if user is None:
            return self._error("NoSuchEntity", name, 404)
        if new_name:
            user["name"] = new_name
        self.store.save(config)
        self._sync_s3(config)
        return self._ok("UpdateUser")

    def _do_DeleteUser(self, params: dict):
        name = params.get("UserName", "")
        config = self.store.load()
        before = len(config.get("identities", []))
        config["identities"] = [i for i in config.get("identities", [])
                                if i["name"] != name]
        if len(config["identities"]) == before:
            return self._error("NoSuchEntity", name, 404)
        self.store.save(config)
        self._sync_s3(config)
        return self._ok("DeleteUser")

    # -- access keys ---------------------------------------------------------
    def _do_CreateAccessKey(self, params: dict):
        name = params.get("UserName", "")
        config = self.store.load()
        user = self._find_user(config, name)
        if user is None:  # AWS auto-creates for unknown users? No: error
            return self._error("NoSuchEntity", name, 404)
        access_key = "AKIA" + secrets.token_hex(8).upper()
        secret_key = secrets.token_urlsafe(30)
        user["access_key"] = access_key
        user["secret_key"] = secret_key
        self.store.save(config)
        self._sync_s3(config)
        return self._ok("CreateAccessKey", {"AccessKey": {
            "UserName": name, "AccessKeyId": access_key,
            "SecretAccessKey": secret_key, "Status": "Active"}})

    def _do_DeleteAccessKey(self, params: dict):
        name = params.get("UserName", "")
        key_id = params.get("AccessKeyId", "")
        config = self.store.load()
        user = self._find_user(config, name)
        if user is None:
            return self._error("NoSuchEntity", name, 404)
        if user.get("access_key") == key_id:
            user["access_key"] = ""
            user["secret_key"] = ""
            self.store.save(config)
            self._sync_s3(config)
        return self._ok("DeleteAccessKey")

    def _do_ListAccessKeys(self, params: dict):
        name = params.get("UserName", "")
        config = self.store.load()
        users = config.get("identities", [])
        if name:
            users = [u for u in users if u["name"] == name]
        return self._ok("ListAccessKeys", {"AccessKeyMetadata": [
            {"UserName": u["name"], "AccessKeyId": u.get("access_key", ""),
             "Status": "Active"}
            for u in users if u.get("access_key")
        ], "IsTruncated": "false"})

    # -- policies ------------------------------------------------------------
    def _do_PutUserPolicy(self, params: dict):
        name = params.get("UserName", "")
        document = params.get("PolicyDocument", "")
        config = self.store.load()
        user = self._find_user(config, name)
        if user is None:
            return self._error("NoSuchEntity", name, 404)
        try:
            policy = json.loads(document)
        except ValueError:
            return self._error("MalformedPolicyDocument", "bad JSON", 400)
        user["actions"] = _policy_to_actions(policy)
        user["policy"] = document
        self.store.save(config)
        self._sync_s3(config)
        return self._ok("PutUserPolicy")

    def _do_GetUserPolicy(self, params: dict):
        name = params.get("UserName", "")
        user = self._find_user(self.store.load(), name)
        if user is None or not user.get("policy"):
            return self._error("NoSuchEntity", name, 404)
        return self._ok("GetUserPolicy", {
            "UserName": name,
            "PolicyName": params.get("PolicyName", "default"),
            "PolicyDocument": user["policy"]})

    def _do_DeleteUserPolicy(self, params: dict):
        name = params.get("UserName", "")
        config = self.store.load()
        user = self._find_user(config, name)
        if user is None:
            return self._error("NoSuchEntity", name, 404)
        user.pop("policy", None)
        user["actions"] = []
        self.store.save(config)
        self._sync_s3(config)
        return self._ok("DeleteUserPolicy")
