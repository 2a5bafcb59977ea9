"""Authentication + access control.

Reference roles: server/security/AuthenticationFilter.java (request
authentication), plugin/trino-password-file (PasswordAuthenticator), and
spi/security/SystemAccessControl + the file-based access control plugin
(plugin/trino-file-based-access-control rules: user/catalog/schema/table
patterns with privilege sets).

Port of trino_tpu/server/security.py: a copy (standard library only).
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import re
from dataclasses import dataclass
from typing import Optional, Sequence


class AccessDeniedError(PermissionError):
    pass


class AuthenticationError(PermissionError):
    pass


# -- authentication (password-file plugin role) ------------------------------


class PasswordAuthenticator:
    """user -> salted-hash store; constant-time verification."""

    #: PBKDF2 rounds (reference password-file plugin uses bcrypt/PBKDF2;
    #: kept modest because tests create many users per run)
    ROUNDS = 50_000

    def __init__(self, users: Optional[dict] = None):
        #: user -> (random salt bytes, pbkdf2_hmac(sha256) digest)
        self._users: dict[str, tuple] = {}
        for user, password in (users or {}).items():
            self.set_password(user, password)

    def set_password(self, user: str, password: str) -> None:
        import os

        salt = os.urandom(16)
        digest = hashlib.pbkdf2_hmac(
            "sha256", password.encode(), salt, self.ROUNDS
        )
        self._users[user] = (salt, digest)

    def authenticate(self, user: str, password: str) -> bool:
        entry = self._users.get(user)
        if entry is None:
            return False
        salt, expect = entry
        got = hashlib.pbkdf2_hmac("sha256", password.encode(), salt, self.ROUNDS)
        return hmac.compare_digest(got, expect)

    @classmethod
    def from_file(cls, path: str) -> "PasswordAuthenticator":
        """password file: `user:password` lines (the password-file plugin's
        format, plaintext variant for tests)."""
        auth = cls()
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                user, _, password = line.partition(":")
                auth.set_password(user, password)
        return auth

    def authenticate_basic(self, header: Optional[str]) -> str:
        """Authorization: Basic ... -> user, or raise."""
        if not header or not header.startswith("Basic "):
            raise AuthenticationError("missing basic credentials")
        try:
            raw = base64.b64decode(header[6:]).decode()
            user, _, password = raw.partition(":")
        except Exception as e:
            raise AuthenticationError("malformed basic credentials") from e
        if not self.authenticate(user, password):
            raise AuthenticationError(f"invalid credentials for {user}")
        return user


# -- access control (SystemAccessControl + file-based rules role) ------------


@dataclass(frozen=True)
class AccessRule:
    """One rule: patterns + allowed privileges, first match wins."""

    user: str = ".*"
    catalog: str = ".*"
    schema: str = ".*"
    table: str = ".*"
    privileges: tuple = ("SELECT", "INSERT", "UPDATE", "DELETE", "OWNERSHIP")

    def matches(self, user: str, catalog: str, schema: str, table: str) -> bool:
        return (
            re.fullmatch(self.user, user) is not None
            and re.fullmatch(self.catalog, catalog) is not None
            and re.fullmatch(self.schema, schema) is not None
            and re.fullmatch(self.table, table) is not None
        )


class AccessControl:
    """SPI (spi/security/SystemAccessControl)."""

    def check_can_execute_query(self, user: str) -> None:
        pass

    def check_can_select(
        self, user: str, catalog: str, schema: str, table: str
    ) -> None:
        pass

    def check_can_write(
        self, user: str, catalog: str, schema: str, table: str
    ) -> None:
        pass

    def check_can_delete(
        self, user: str, catalog: str, schema: str, table: str
    ) -> None:
        pass

    def check_can_update(
        self, user: str, catalog: str, schema: str, table: str
    ) -> None:
        pass

    def filter_catalogs(self, user: str, catalogs: Sequence[str]) -> list:
        return list(catalogs)


class AllowAllAccessControl(AccessControl):
    pass


class GrantManager:
    """SQL-standard grants + roles store (reference roles:
    spi/security/Privilege.java, MetadataManager.grantTablePrivileges, and
    plugin/trino-hive SqlStandardAccessControl's grant model).

    Grants are keyed by principal (user or role); role membership is
    transitive (roles may be granted to roles)."""

    PRIVILEGES = ("SELECT", "INSERT", "UPDATE", "DELETE", "OWNERSHIP")

    def __init__(self):
        #: (principal, catalog, schema, table) -> set of privileges
        self._grants: dict[tuple, set] = {}
        #: role -> set of member principals (users or roles)
        self._roles: dict[str, set] = {}
        #: (catalog, schema, table) -> owner user
        self._owners: dict[tuple, str] = {}

    # -- roles ---------------------------------------------------------------

    def create_role(self, role: str) -> None:
        if role in self._roles:
            raise ValueError(f"role {role!r} already exists")
        self._roles[role] = set()

    def drop_role(self, role: str) -> None:
        if role not in self._roles:
            raise ValueError(f"role {role!r} does not exist")
        del self._roles[role]
        for members in self._roles.values():
            members.discard(role)

    def list_roles(self) -> list:
        return sorted(self._roles)

    def grant_role(self, role: str, principal: str) -> None:
        if role not in self._roles:
            raise ValueError(f"role {role!r} does not exist")
        self._roles[role].add(principal)

    def revoke_role(self, role: str, principal: str) -> None:
        if role not in self._roles:
            raise ValueError(f"role {role!r} does not exist")
        self._roles[role].discard(principal)

    def principals_of(self, user: str) -> set:
        """user + every role reachable through membership (transitive)."""
        out = {user}
        changed = True
        while changed:
            changed = False
            for role, members in self._roles.items():
                if role not in out and members & out:
                    out.add(role)
                    changed = True
        return out

    # -- privileges ----------------------------------------------------------

    def grant(self, principal, privileges, catalog, schema, table) -> None:
        key = (principal, catalog, schema, table)
        st = self._grants.setdefault(key, set())
        for p in privileges:
            p = p.upper()
            if p not in self.PRIVILEGES and p != "ALL":
                raise ValueError(f"unknown privilege {p}")
            if p == "ALL":
                st.update(self.PRIVILEGES)
            else:
                st.add(p)

    def revoke(self, principal, privileges, catalog, schema, table) -> None:
        key = (principal, catalog, schema, table)
        st = self._grants.get(key)
        if st is None:
            return
        for p in privileges:
            p = p.upper()
            if p == "ALL":
                st.clear()
            else:
                st.discard(p)
        if not st:
            del self._grants[key]

    def set_owner(self, catalog, schema, table, user) -> None:
        self._owners[(catalog, schema, table)] = user

    def has_privilege(self, user, priv, catalog, schema, table) -> bool:
        if self._owners.get((catalog, schema, table)) == user:
            return True
        principals = self.principals_of(user)
        for p in principals:
            st = self._grants.get((p, catalog, schema, table))
            if st and (priv in st or "OWNERSHIP" in st):
                return True
        return False

    def grants_for(self, catalog=None, schema=None, table=None) -> list:
        """(grantee, privilege, catalog, schema, table) rows for SHOW GRANTS."""
        out = []
        for (p, c, s, t), privs in sorted(self._grants.items()):
            if catalog is not None and (c, s, t) != (catalog, schema, table):
                continue
            for pr in sorted(privs):
                out.append((p, pr, c, s, t))
        return out


class SqlStandardAccessControl(AccessControl):
    """GRANT-driven enforcement (reference: trino-hive SqlStandardAccessControl
    semantics: owner or granted privilege required; `admin` bypasses)."""

    def __init__(self, grants: GrantManager, admin: str = "admin"):
        self.grants = grants
        self.admin = admin

    def _check(self, priv, user, catalog, schema, table) -> None:
        if user == self.admin:
            return
        if not self.grants.has_privilege(user, priv, catalog, schema, table):
            raise AccessDeniedError(
                f"user {user} lacks {priv} on {catalog}.{schema}.{table}"
            )

    def check_can_select(self, user, catalog, schema, table) -> None:
        self._check("SELECT", user, catalog, schema, table)

    def check_can_write(self, user, catalog, schema, table) -> None:
        self._check("INSERT", user, catalog, schema, table)

    def check_can_delete(self, user, catalog, schema, table) -> None:
        self._check("DELETE", user, catalog, schema, table)

    def check_can_update(self, user, catalog, schema, table) -> None:
        self._check("UPDATE", user, catalog, schema, table)


class RuleBasedAccessControl(AccessControl):
    """File-based access control semantics: first matching rule decides;
    no matching rule denies."""

    def __init__(self, rules: Sequence[AccessRule], query_users: str = ".*"):
        self.rules = list(rules)
        self.query_users = query_users

    @classmethod
    def from_dicts(cls, rules: Sequence[dict], **kw) -> "RuleBasedAccessControl":
        return cls(
            [
                AccessRule(
                    user=r.get("user", ".*"),
                    catalog=r.get("catalog", ".*"),
                    schema=r.get("schema", ".*"),
                    table=r.get("table", ".*"),
                    privileges=tuple(
                        p.upper() for p in r.get("privileges", ())
                    ),
                )
                for r in rules
            ],
            **kw,
        )

    def check_can_execute_query(self, user: str) -> None:
        if re.fullmatch(self.query_users, user) is None:
            raise AccessDeniedError(f"user {user} cannot execute queries")

    def _check(self, priv, user, catalog, schema, table) -> None:
        for rule in self.rules:
            if rule.matches(user, catalog, schema, table):
                if priv in rule.privileges:
                    return
                break  # first match decides
        raise AccessDeniedError(
            f"user {user} lacks {priv} on {catalog}.{schema}.{table}"
        )

    def check_can_select(self, user, catalog, schema, table) -> None:
        self._check("SELECT", user, catalog, schema, table)

    def check_can_write(self, user, catalog, schema, table) -> None:
        self._check("INSERT", user, catalog, schema, table)

    def check_can_delete(self, user, catalog, schema, table) -> None:
        self._check("DELETE", user, catalog, schema, table)

    def check_can_update(self, user, catalog, schema, table) -> None:
        self._check("UPDATE", user, catalog, schema, table)

    def filter_catalogs(self, user: str, catalogs: Sequence[str]) -> list:
        """First-match-wins (like _check): the FIRST rule matching
        user+catalog decides visibility, and only if it grants at least one
        privilege — a privilege-less rule must not reveal the catalog."""
        out = []
        for c in catalogs:
            for r in self.rules:
                if re.fullmatch(r.user, user) and re.fullmatch(r.catalog, c):
                    if r.privileges:
                        out.append(c)
                    break  # first match decides
        return out
